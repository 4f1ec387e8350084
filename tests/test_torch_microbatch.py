"""The port's microbatch accumulation against the JAX package's.

The reduced transformer-big (f32), parameters from the reference's
``init`` through the bridge, one seed-made batch of 4 x 8 tokens.
``split_microbatches`` must be exact; ``accumulate_microbatches`` at
M in {2, 4}, dense and sparse embedding, with and without
``defer_final``, must give the reference's contribution structure (list
lengths, IndexedSlices indices exactly) with gradients within rtol 5e-5,
atol 5e-6 and the loss within rtol 1e-5 (the tolerances of
``tests/test_microbatch.py``; the two frameworks sum in other orders).
The reference runs jitted with XLA's backend optimisation turned down,
which keeps the file's compile time short and changes no semantics.
"""
from concurrent.futures import ThreadPoolExecutor

import pytest

torch = pytest.importorskip("torch")

import jax                                    # noqa: E402
import jax.numpy as jnp                       # noqa: E402
import numpy as np                            # noqa: E402

from repro.configs import get_config as jget_config          # noqa: E402
from repro.core.indexed_slices import (                      # noqa: E402
    IndexedSlices as JIndexedSlices)
from repro.data import make_pipeline as jmake_pipeline         # noqa: E402
from repro.models import build_model as jbuild_model           # noqa: E402
from repro.training import microbatch as jmb                   # noqa: E402
from repro_torch import bridge                                  # noqa: E402
from repro_torch.configs import get_config                      # noqa: E402
from repro_torch.core.indexed_slices import IndexedSlices      # noqa: E402
from repro_torch.models import build_model                      # noqa: E402
from repro_torch.training import microbatch as mb               # noqa: E402
from repro_torch.tree import tree_flatten                       # noqa: E402

jax.config.update("jax_platform_name", "cpu")

GRAD_TOL = dict(rtol=5e-5, atol=5e-6)
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def jit_fast(fn, *args):
    """Run the reference's ``fn(*args)`` jitted, compiled with low XLA
    optimisation (the same program, compiled faster)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options=FAST_COMPILE)(*args)


@pytest.fixture(scope="module")
def setup():
    jcfg = jget_config("transformer-big").reduced()
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    np_batch = jmake_pipeline(jcfg, 4, 8, seed=0).batch_at(0)
    model = build_model(get_config("transformer-big").reduced())
    params = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jparams),
                             "cpu")
    batch = {k: torch.from_numpy(np.array(v)) for k, v in np_batch.items()}
    jbatch = {k: jnp.asarray(v) for k, v in np_batch.items()}
    return jmodel, jparams, jbatch, model, params, batch


def _jleaves(tree):
    return jax.tree_util.tree_leaves(
        tree, is_leaf=lambda x: isinstance(x, (list, JIndexedSlices)))


def assert_contribs_close(got, want):
    """Same contribution structure; values within GRAD_TOL."""
    tl, jl = tree_flatten(got)[0], _jleaves(want)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        assert isinstance(t, list) == isinstance(j, list)
        ts = t if isinstance(t, list) else [t]
        js = j if isinstance(j, list) else [j]
        assert len(ts) == len(js)
        for a, b in zip(ts, js):
            assert isinstance(a, IndexedSlices) == isinstance(
                b, JIndexedSlices)
            if isinstance(a, IndexedSlices):
                np.testing.assert_array_equal(a.indices.numpy(),
                                              np.asarray(b.indices))
                assert tuple(a.dense_shape) == tuple(b.dense_shape)
                a, b = a.values, b.values
            assert tuple(a.shape) == tuple(b.shape)
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       **GRAD_TOL)


def test_split_microbatches_matches_reference(setup):
    _, _, jbatch, _, _, batch = setup
    for n in (1, 2, 4):
        got = mb.split_microbatches(batch, n)
        want = jmb.split_microbatches(jbatch, n)
        for k in batch:
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
        assert got["tokens"].shape[:2] == (n, 4 // n)


@pytest.fixture(scope="module")
def reference(setup):
    """The reference's ``accumulate_microbatches`` for every (M, sparse):
    one program each with and without ``defer_final``, traced in turn and
    compiled on parallel threads (XLA's compile releases the GIL)."""
    jmodel, jparams, jbatch = setup[:3]
    cases = [(n, sparse) for n in (2, 4) for sparse in (False, True)]

    def lower(n, sparse):
        return jax.jit(lambda p, b: tuple(jmb.accumulate_microbatches(
            jmodel, p, jmb.split_microbatches(b, n),
            sparse_embedding=sparse, defer_final=d)
            for d in (False, True))).lower(jparams, jbatch)

    lowered = [lower(*c) for c in cases]
    with ThreadPoolExecutor(len(cases)) as pool:
        compiled = list(pool.map(
            lambda lo: lo.compile(compiler_options=FAST_COMPILE), lowered))
    return {c: fn(jparams, jbatch) for c, fn in zip(cases, compiled)}


@pytest.mark.parametrize("defer_final", [False, True])
@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("n", [2, 4])
def test_accumulate_microbatches_matches_reference(setup, reference, n,
                                                   sparse, defer_final):
    _, _, _, model, params, batch = setup
    jg, jloss, _ = reference[n, sparse][int(defer_final)]
    g, loss, _ = mb.accumulate_microbatches(
        model, params, mb.split_microbatches(batch, n),
        sparse_embedding=sparse, defer_final=defer_final)
    assert_contribs_close(g, jg)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    if defer_final:          # every leaf is [partial..., final...]
        emb = g["embedding"]
        assert isinstance(emb, list)
        assert len(emb) == (4 if sparse else 2)
