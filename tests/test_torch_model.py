"""The port's model and gradients against the JAX package.

The reference's parameters cross through ``repro_torch.bridge`` (bitwise),
the batch comes from both pipelines (bitwise equal), and the loss and
every gradient leaf are compared.  Tolerances: loss rtol 1e-5; gradients
atol 1e-5, rtol 1e-4 in f32, because XLA and torch sum in different
orders; embedding IndexedSlices indices exactly.
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
from repro_torch.data import make_pipeline                      # noqa: E402
from repro_torch.models import build_model                      # noqa: E402
from repro_torch.training.gradients import grad_contributions    # noqa: E402
from repro_torch.tree import tree_flatten                       # noqa: E402

jax.config.update("jax_platform_name", "cpu")

GRAD_TOL = dict(atol=1e-5, rtol=1e-4)


def _jleaves(tree):
    return jax.tree_util.tree_flatten(
        tree, is_leaf=lambda x: isinstance(x, (list, JSlices)))[0]


@pytest.fixture(scope="module")
def reduced():
    jcfg = jget_config("transformer-big").reduced()
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jparams))
    return jmodel, jparams, build_model(get_config("transformer-big")
                                        .reduced()), tparams


def test_reduced_config_matches_reference():
    t = get_config("transformer-big").reduced()
    j = jget_config("transformer-big").reduced()
    for f in ("name", "family", "n_layers", "d_model", "n_heads",
              "n_kv_heads", "d_ff", "vocab", "head_dim", "tied_embeddings",
              "rope_theta", "rope_fraction", "norm_eps", "dtype",
              "sliding_window", "attn_every"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.frontend.n_embeds == j.frontend.n_embeds
    assert t.frontend.cross_attention == j.frontend.cross_attention
    full = get_config("transformer-big")
    assert (full.d_model, full.vocab, full.n_layers, full.dtype) == (
        1024, 33708, 6, "bfloat16")


@pytest.mark.parametrize("task,seed", [("lm", 0), ("translation", 3),
                                       ("copy", 11)])
def test_pipeline_batches_bitwise_equal(task, seed):
    tcfg = get_config("transformer-big").reduced()
    jcfg = jget_config("transformer-big").reduced()
    tp = make_pipeline(tcfg, 3, 24, seed=seed, host_id=1, task=task)
    jp = jmake_pipeline(jcfg, 3, 24, seed=seed, host_id=1, task=task)
    for step in (0, 1, 7):
        tb, jb = tp.batch_at(step), jp.batch_at(step)
        assert sorted(tb) == sorted(jb)
        for k in tb:
            assert tb[k].dtype == jb[k].dtype
            np.testing.assert_array_equal(tb[k], jb[k])


def test_init_layout_matches_reference():
    """Same leaves, shapes, dtypes and flatten order at full width (meta
    tensors, no memory), and the reference's scales at reduced width."""
    cfg = get_config("transformer-big")
    tparams = build_model(cfg).init(device="meta")
    jparams = jax.eval_shape(jbuild_model(jget_config("transformer-big"))
                             .init, jax.random.PRNGKey(0))
    tl, jl = tree_flatten(tparams)[0], jax.tree_util.tree_leaves(jparams)
    assert [tuple(x.shape) for x in tl] == [tuple(x.shape) for x in jl]
    assert all(str(x.dtype) == "torch.bfloat16" for x in tl)
    assert [str(x.dtype) for x in jl] == ["bfloat16"] * len(jl)
    assert sorted(tparams) == sorted(jparams) == ["embedding", "final_norm",
                                                  "layers"]
    small = build_model(cfg.reduced()).init(seed=1, device="cpu")
    jsmall = jbuild_model(jget_config("transformer-big").reduced()).init(
        jax.random.PRNGKey(1))
    for t, j in zip(tree_flatten(small)[0], jax.tree_util.tree_leaves(jsmall)):
        assert t.dtype == torch.float32
        np.testing.assert_allclose(float(t.std()) if t.numel() > 1 else 0.0,
                                   float(jnp.std(j)) if j.size > 1 else 0.0,
                                   rtol=0.1, atol=1e-6)


@pytest.mark.parametrize("sparse_embedding", [False, True])
@pytest.mark.parametrize("task,loss_chunk", [("lm", 1024),
                                             ("translation", 6)])
def test_loss_and_grads_match_jax(reduced, sparse_embedding, task,
                                  loss_chunk):
    jmodel, jparams, tmodel, tparams = reduced
    batch = jmake_pipeline(jmodel.cfg, 2, 16, seed=5, task=task).batch_at(0)
    jg, jloss, jm = jgrad_contributions(
        jmodel, jparams, {k: jnp.asarray(v) for k, v in batch.items()},
        sparse_embedding=sparse_embedding, loss_chunk=loss_chunk)
    tg, tloss, tm = grad_contributions(
        tmodel, tparams, {k: torch.from_numpy(v) for k, v in batch.items()},
        sparse_embedding=sparse_embedding, loss_chunk=loss_chunk)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(tm["tokens"]), float(jm["tokens"]))
    tl, jl = tree_flatten(tg)[0], _jleaves(jg)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        if isinstance(j, list):
            assert isinstance(t, list) and len(t) == len(j) == 2
            assert isinstance(t[0], TSlices) and isinstance(j[0], JSlices)
            np.testing.assert_array_equal(t[0].indices.numpy(),
                                          np.asarray(j[0].indices))
            assert t[0].dense_shape == tuple(j[0].dense_shape)
            np.testing.assert_allclose(t[0].values.numpy(),
                                       np.asarray(j[0].values), **GRAD_TOL)
            np.testing.assert_allclose(t[1].numpy(), np.asarray(j[1]),
                                       **GRAD_TOL)
        else:
            assert tuple(t.shape) == tuple(j.shape)
            np.testing.assert_allclose(t.numpy(), np.asarray(j), **GRAD_TOL)
