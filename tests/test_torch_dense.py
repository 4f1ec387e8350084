"""The port's dense family against the JAX package's, on the reduced
llama3.2-1b, chatglm3-6b, qwen2.5-32b and deepseek-7b in f32: configs,
parameters, loss and gradients (decode and serving in
tests/test_torch_dense_decode.py, the launcher in
tests/test_torch_dense_train.py).

The reference's parameters cross through ``repro_torch.bridge``
(bitwise).  The reference initialises the q/k/v biases (chatglm3, qwen2.5)
to zeros, so both sides get the same non-zero biases from a numpy seed: a
port that dropped them would fail.  Tolerances as in
tests/test_torch_model.py and tests/test_torch_decode.py: loss rtol 1e-5;
gradients atol 1e-5, rtol 1e-4 (XLA and torch sum in different orders);
IndexedSlices indices exactly.
"""
import dataclasses

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
from repro_torch.configs import ArchConfig, get_config          # noqa: E402
from repro_torch.core.indexed_slices import IndexedSlices as TSlices  # noqa: E402
from repro_torch.models import build_model                      # noqa: E402
from repro_torch.training.gradients import grad_contributions    # noqa: E402
from repro_torch.tree import tree_flatten                       # noqa: E402

jax.config.update("jax_platform_name", "cpu")

DENSE = ("llama3.2-1b", "chatglm3-6b", "qwen2.5-32b", "deepseek-7b")
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)


def config_fields(t, j):
    """Every field of the port's config against the reference's; the
    reference's fields the port leaves out (moe, mla, xlstm) are None."""
    for f in dataclasses.fields(ArchConfig):
        tv, jv = getattr(t, f.name), getattr(j, f.name)
        if dataclasses.is_dataclass(tv):
            assert dataclasses.asdict(tv) == dataclasses.asdict(jv), f.name
        else:
            assert tv == jv, f.name
    ported = {f.name for f in dataclasses.fields(ArchConfig)}
    for f in dataclasses.fields(j):
        if f.name not in ported:
            assert getattr(j, f.name) is None, f.name


def with_biases(jparams, seed=7):
    """numpy copy of the reference's parameters with every q/k/v bias
    drawn from a seed (the reference initialises them to zeros)."""
    p = jax.tree_util.tree_map(np.asarray, jparams)
    rng = np.random.default_rng(seed)
    attn = p["layers"]["attn"]
    for name in ("bq", "bk", "bv"):
        if name in attn:
            attn[name] = (0.5 * rng.standard_normal(attn[name].shape)
                          ).astype(attn[name].dtype)
    return p


def build(arch):
    jmodel = jbuild_model(jget_config(arch).reduced())
    p = with_biases(jmodel.init(jax.random.PRNGKey(0)))
    jparams = jax.tree_util.tree_map(jnp.asarray, p)
    return jmodel, jparams, build_model(get_config(arch).reduced()), \
        bridge.to_torch(p, "cpu")


@pytest.fixture(scope="module", params=DENSE)
def models(request):
    return build(request.param)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _jleaves(tree):
    return jax.tree_util.tree_flatten(
        tree, is_leaf=lambda x: isinstance(x, (list, JSlices)))[0]


@pytest.mark.parametrize("arch", DENSE)
def test_config_matches_reference(arch):
    config_fields(get_config(arch), jget_config(arch))
    config_fields(get_config(arch).reduced(), jget_config(arch).reduced())
    assert get_config(arch).family == "dense"


def test_biases_follow_the_config(models):
    jmodel, jparams, tmodel, tparams = models
    attn = tparams["layers"]["attn"]
    assert sorted(attn) == sorted(jparams["layers"]["attn"])
    assert ("bq" in attn) == tmodel.cfg.qkv_bias
    fresh = tmodel.init(seed=0, device="cpu")["layers"]["attn"]
    for name in ("bq", "bk", "bv"):
        if tmodel.cfg.qkv_bias:
            assert float(attn[name].abs().min()) > 0.0
            assert not bool(fresh[name].any())        # zeros, as the reference
            assert fresh[name].shape == attn[name].shape


def _compare_grads(tg, jg):
    tl, jl = tree_flatten(tg)[0], _jleaves(jg)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        if isinstance(j, list):
            assert isinstance(t, list) and len(t) == len(j)
            for tp, jp in zip(t, j):
                if isinstance(jp, JSlices):
                    assert isinstance(tp, TSlices)
                    np.testing.assert_array_equal(tp.indices.numpy(),
                                                  np.asarray(jp.indices))
                    assert tp.dense_shape == tuple(jp.dense_shape)
                    np.testing.assert_allclose(tp.values.numpy(),
                                               np.asarray(jp.values),
                                               **GRAD_TOL)
                else:
                    np.testing.assert_allclose(tp.numpy(), np.asarray(jp),
                                               **GRAD_TOL)
        else:
            assert tuple(t.shape) == tuple(j.shape)
            np.testing.assert_allclose(t.numpy(), np.asarray(j), **GRAD_TOL)


@pytest.mark.parametrize("sparse_embedding", [False, True])
def test_loss_and_grads_match_jax(models, sparse_embedding):
    jmodel, jparams, tmodel, tparams = models
    batch = jmake_pipeline(jmodel.cfg, 2, 16, seed=5).batch_at(0)
    jg, jloss, jm = jgrad_contributions(
        jmodel, jparams, {k: jnp.asarray(v) for k, v in batch.items()},
        sparse_embedding=sparse_embedding)
    tg, tloss, tm = grad_contributions(
        tmodel, tparams, {k: torch.from_numpy(v) for k, v in batch.items()},
        sparse_embedding=sparse_embedding)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(tm["tokens"]), float(jm["tokens"]))
    _compare_grads(tg, jg)
    if tmodel.cfg.qkv_bias:
        for name in ("bq", "bk", "bv"):
            assert float(tg["layers"]["attn"][name].abs().max()) > 0.0
    assert ("lm_head" in tg) == (not tmodel.cfg.tied_embeddings)
