"""The port's accumulation (paper Alg. 1 / Alg. 2 / sparse_as_dense) held
against the JAX package on the cases of tests/test_accumulation.py: the
same IndexedSlices-or-dense representation, equal indices, values within
1e-6 and equal accumulated byte counts."""
import pytest

torch = pytest.importorskip("torch")

import jax                                    # noqa: E402
import jax.numpy as jnp                       # noqa: E402
import numpy as np                            # noqa: E402
from hypothesis import given, settings, strategies as st   # noqa: E402

from repro.core import accumulation as jacc                # noqa: E402
from repro.core.indexed_slices import (IndexedSlices as JSlices,  # noqa: E402
                                       concat_slices as jconcat)
from repro_torch.core import accumulation as tacc          # noqa: E402
from repro_torch.core.indexed_slices import (IndexedSlices as TSlices,  # noqa: E402
                                             concat_slices as tconcat)

jax.config.update("jax_platform_name", "cpu")

TOL = dict(rtol=1e-6, atol=1e-6)


@st.composite
def contributions(draw):
    """A mixed list of dense / sparse numpy contributions for one (v, d)
    variable: ("sparse", idx, vals) or ("dense", array)."""
    v = draw(st.integers(2, 40))
    d = draw(st.integers(1, 16))
    n_contrib = draw(st.integers(1, 5))
    kinds = draw(st.lists(st.booleans(), min_size=n_contrib,
                          max_size=n_contrib))
    rng = np.random.default_rng(draw(st.integers(0, 2**31 - 1)))
    out = []
    for sparse in kinds:
        if sparse:
            n = int(rng.integers(1, 3 * v))
            out.append(("sparse", rng.integers(0, v, size=(n,)).astype(
                np.int32), rng.standard_normal((n, d)).astype(np.float32),
                (v, d)))
        else:
            out.append(("dense", rng.standard_normal((v, d)).astype(
                np.float32)))
    return out


def _jax(c):
    if c[0] == "sparse":
        return JSlices(jnp.asarray(c[1]), jnp.asarray(c[2]), c[3])
    return jnp.asarray(c[1])


def _torch(c):
    if c[0] == "sparse":
        return TSlices(torch.from_numpy(c[1]), torch.from_numpy(c[2]), c[3])
    return torch.from_numpy(c[1])


def assert_same(t_out, j_out):
    """Same representation, equal indices, values within 1e-6, equal
    accumulated bytes."""
    if isinstance(j_out, JSlices):
        assert isinstance(t_out, TSlices)
        assert t_out.dense_shape == tuple(j_out.dense_shape)
        assert t_out.indices.dtype == torch.int32
        np.testing.assert_array_equal(t_out.indices.numpy(),
                                      np.asarray(j_out.indices))
        np.testing.assert_allclose(t_out.values.numpy(),
                                   np.asarray(j_out.values), **TOL)
    else:
        assert isinstance(t_out, torch.Tensor)
        np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **TOL)
    assert tacc.accumulated_nbytes(t_out) == jacc.accumulated_nbytes(j_out)


@given(contributions())
@settings(max_examples=25, deadline=None)
def test_accumulation_matches_jax(contribs):
    """Alg. 1, Alg. 2, with and without the sparse_as_dense pre-pass."""
    j_in = [_jax(c) for c in contribs]
    t_in = [_torch(c) for c in contribs]
    for algorithm in ("tf_algorithm1", "proposed_algorithm2"):
        for sad in (False, True):
            assert_same(
                tacc.accumulate_gradients(t_in, algorithm=algorithm,
                                          sparse_as_dense=sad),
                jacc.accumulate_gradients(j_in, algorithm=algorithm,
                                          sparse_as_dense=sad))


@given(contributions())
@settings(max_examples=6, deadline=None)
def test_accumulation_with_densify_kernel_matches_jax(contribs):
    """``use_kernel=True``: the port's plain densify against the Pallas
    kernel in interpret mode."""
    j_in = [_jax(c) for c in contribs]
    t_in = [_torch(c) for c in contribs]
    for algorithm, sad in (("proposed_algorithm2", False),
                           ("tf_algorithm1", True)):
        assert_same(
            tacc.accumulate_gradients(t_in, algorithm=algorithm,
                                      sparse_as_dense=sad, use_kernel=True),
            jacc.accumulate_gradients(j_in, algorithm=algorithm,
                                      sparse_as_dense=sad, use_kernel=True))


@given(contributions())
@settings(max_examples=10, deadline=None)
def test_densify_each_contribution_matches_jax(contribs):
    for c in contribs:
        assert_same(tacc.densify(_torch(c)), jacc.densify(_jax(c)))


def test_dense_to_slices_matches_jax():
    g = np.random.default_rng(0).standard_normal((7, 3)).astype(np.float32)
    assert_same(tacc.dense_to_slices(torch.from_numpy(g)),
                jacc.dense_to_slices(jnp.asarray(g)))
    np.testing.assert_allclose(
        tacc.densify(tacc.dense_to_slices(torch.from_numpy(g))).numpy(), g)


def test_concat_slices_matches_jax():
    a = ("sparse", np.array([0, 1], np.int32), np.ones((2, 2), np.float32),
         (3, 2))
    b = ("sparse", np.array([1, 2], np.int32), np.ones((2, 2), np.float32),
         (3, 2))
    t = tconcat((_torch(a), _torch(b)))
    assert_same(t, jconcat((_jax(a), _jax(b))))
    np.testing.assert_allclose(tacc.densify(t).numpy(),
                               [[1, 1], [2, 2], [1, 1]])
    assert t.nbytes == 4 * 4 + 4 * 2 * 4


def test_concat_slices_shape_mismatch_raises():
    a = TSlices(torch.tensor([0], dtype=torch.int32), torch.ones(1, 2),
                (3, 2))
    b = TSlices(torch.tensor([0], dtype=torch.int32), torch.ones(1, 2),
                (4, 2))
    with pytest.raises(ValueError):
        tconcat((a, b))
    with pytest.raises(ValueError):
        tconcat(())


def test_unknown_algorithm_raises():
    with pytest.raises(ValueError):
        tacc.accumulate_gradients([torch.ones(2, 2)], algorithm="nope")
