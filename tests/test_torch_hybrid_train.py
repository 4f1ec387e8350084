"""The port's training gradients on the hybrid family against the JAX
package's, on the reduced zamba2-7b in f32.

The reference's parameters cross through ``repro_torch.bridge``
(bitwise) and the batch comes from the reference's pipeline.  Both sides
train through the chunked SSD scan (``ssd_chunked``: the reference's
model path, and the port's under ``attn_impl="chunked"``); the SSD
kernels are forward-only and never on the training path.  The loss and
every gradient leaf are compared, with ``sparse_embedding`` False (dense
autograd) and True (the untied table gets the per-token IndexedSlices
only).  Tolerances as in tests/test_torch_model.py: loss rtol 1e-5;
gradients atol 1e-5, rtol 1e-4 in f32, because XLA and torch sum in
different orders; IndexedSlices indices exactly.
"""
import pytest

torch = pytest.importorskip("torch")

import jax                                    # noqa: E402
import jax.numpy as jnp                       # noqa: E402
import numpy as np                            # noqa: E402

from repro.configs import get_config as jget_config          # noqa: E402
from repro.core.indexed_slices import IndexedSlices as JSlices  # noqa: E402
from repro.data import make_pipeline as jmake_pipeline         # noqa: E402
from repro.models import build_model as jbuild_model           # noqa: E402
from repro.training.gradients import (                          # noqa: E402
    grad_contributions as jgrad_contributions)
from repro_torch import bridge                                  # noqa: E402
from repro_torch.configs import get_config                      # noqa: E402
from repro_torch.core.indexed_slices import IndexedSlices as TSlices  # noqa: E402
from repro_torch.models import build_model                      # noqa: E402
from repro_torch.training.gradients import grad_contributions    # noqa: E402
from repro_torch.tree import tree_flatten                       # noqa: E402

jax.config.update("jax_platform_name", "cpu")

GRAD_TOL = dict(atol=1e-5, rtol=1e-4)          # tests/test_torch_model.py


def _jleaves(tree):
    return jax.tree_util.tree_flatten(
        tree, is_leaf=lambda x: isinstance(x, (list, JSlices)))[0]


@pytest.fixture(scope="module")
def reduced():
    jcfg = jget_config("zamba2-7b").reduced()
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jparams),
                              "cpu")
    tmodel = build_model(get_config("zamba2-7b").reduced())
    assert not tmodel.cfg.tied_embeddings
    return jmodel, jparams, tmodel, tparams


@pytest.mark.parametrize("sparse_embedding", [False, True])
def test_loss_and_grads_match_jax(reduced, sparse_embedding):
    jmodel, jparams, tmodel, tparams = reduced
    batch = jmake_pipeline(jmodel.cfg, 2, 16, seed=5).batch_at(0)
    jg, jloss, jm = jgrad_contributions(
        jmodel, jparams, {k: jnp.asarray(v) for k, v in batch.items()},
        sparse_embedding=sparse_embedding)
    tg, tloss, tm = grad_contributions(
        tmodel, tparams, {k: torch.from_numpy(v) for k, v in batch.items()},
        sparse_embedding=sparse_embedding)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(tm["tokens"]), float(jm["tokens"]))
    tl, jl = tree_flatten(tg)[0], _jleaves(jg)
    assert len(tl) == len(jl)
    n_slices = 0
    for t, j in zip(tl, jl):
        if isinstance(j, list):
            # untied table: the sparse rows alone, no dense contribution
            assert isinstance(t, list) and len(t) == len(j) == 1
            assert isinstance(t[0], TSlices) and isinstance(j[0], JSlices)
            np.testing.assert_array_equal(t[0].indices.numpy(),
                                          np.asarray(j[0].indices))
            assert t[0].dense_shape == tuple(j[0].dense_shape)
            np.testing.assert_allclose(t[0].values.numpy(),
                                       np.asarray(j[0].values), **GRAD_TOL)
            n_slices += 1
        else:
            assert tuple(t.shape) == tuple(j.shape)
            np.testing.assert_allclose(t.numpy(), np.asarray(j), **GRAD_TOL)
    assert n_slices == int(sparse_embedding)
    # the gradients reach every Mamba2 block's scan parameters
    for name in ("a_log", "dt_bias", "d_skip"):
        assert float(tg["mamba"][name].abs().max()) > 0.0
