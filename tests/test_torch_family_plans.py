"""The ExchangePlan of each new config at full width, and the reduced
seamless-m4t-large-v2 against the JAX package.

  * plan accounting: one worker's gradient-contribution tree at batch
    8 x 256, on ``meta`` tensors in the port and with ``jax.eval_shape``
    in the reference (as tests/test_torch_exchange.py's
    ``full_width_trees``; nothing is allocated), compiled under
    dense_reduce and sparse_gather with the identity and int8+ef wires:
    leaf specs, buckets, schedule, collective counts and the wire,
    buffer and state bytes exactly equal;
  * seamless-m4t-large-v2 (the audio family's second config, 1024
    cross-attended frames): config fields, forward, loss and gradients
    of the reduced model in f32 at the tolerances of
    tests/test_torch_model.py (loss rtol 1e-5; gradients atol 1e-5,
    rtol 1e-4; IndexedSlices indices exactly).
"""
import pytest

torch = pytest.importorskip("torch")

import jax                                    # noqa: E402
import jax.numpy as jnp                       # noqa: E402
import numpy as np                            # noqa: E402

from repro.configs import get_config as jget_config          # noqa: E402
from repro.core import (ExchangeConfig as JExchangeConfig,   # noqa: E402
                        exchange as jexchange)
from repro.data import make_pipeline as jmake_pipeline         # noqa: E402
from repro.models import build_model as jbuild_model           # noqa: E402
from repro.training.gradients import (                          # noqa: E402
    abstract_grad_contributions, grad_contributions as jgrad_contributions)
from repro_torch import bridge                                  # noqa: E402
from repro_torch.configs import get_config                      # noqa: E402
from repro_torch.core import ExchangeConfig, exchange           # noqa: E402
from repro_torch.models import build_model                      # noqa: E402
from repro_torch.training.gradients import grad_contributions    # noqa: E402
from test_torch_dense import (TOL, _compare_grads, _np, _t,     # noqa: E402
                              config_fields)
from test_torch_exchange import _slot_tuple, _spec_tuple        # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ARCHS = ("llama3.2-1b", "chatglm3-6b", "qwen2.5-32b", "deepseek-7b",
         "seamless-m4t-large-v2", "internvl2-1b")
WIRES = {
    "dense_reduce": dict(sparse_as_dense=True),
    "sparse_gather": dict(),
    "dense_reduce_int8+ef": dict(sparse_as_dense=True, codec="int8",
                                 error_feedback=True),
    "sparse_gather_int8+ef": dict(codec="int8", error_feedback=True),
}
B, S = 8, 256


@pytest.fixture(scope="module", params=ARCHS)
def trees(request):
    """One worker's full-width gradient-contribution tree, shapes only,
    in both packages."""
    arch = request.param
    jcfg = jget_config(arch)
    jmodel = jbuild_model(jcfg)
    jparams = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    sds = jax.ShapeDtypeStruct
    jbatch = {"tokens": sds((B, S), jnp.int32),
              "labels": sds((B, S), jnp.int32)}
    cfg = get_config(arch)
    meta = dict(device="meta")
    tbatch = {"tokens": torch.empty(B, S, dtype=torch.int32, **meta),
              "labels": torch.empty(B, S, dtype=torch.int32, **meta)}
    if cfg.frontend is not None:
        shape = (B, cfg.frontend.n_embeds, cfg.d_model)
        jbatch["frontend"] = sds(shape, jnp.float32)
        tbatch["frontend"] = torch.empty(shape, **meta)
    jg = abstract_grad_contributions(jmodel, jparams, jbatch,
                                     sparse_embedding=True)
    model = build_model(cfg)
    tg, _, _ = grad_contributions(model, model.init(**meta), tbatch,
                                  sparse_embedding=True)
    return arch, tg, jg


@pytest.mark.parametrize("wire", sorted(WIRES))
def test_plan_matches_reference_at_full_width(trees, wire):
    arch, tg, jg = trees
    tplan = exchange.compile_plan(tg, ExchangeConfig(use_kernel=True,
                                                     **WIRES[wire]))
    jplan = jexchange.compile_plan(jg, JExchangeConfig(use_kernel=True,
                                                       **WIRES[wire]))
    assert [_spec_tuple(s) for s in tplan.leaf_specs] == \
        [_spec_tuple(s) for s in jplan.leaf_specs]
    assert tplan.dense_leaf_ids == jplan.dense_leaf_ids
    assert tplan.gather_leaf_ids == jplan.gather_leaf_ids
    assert len(tplan.dense_buckets) == len(jplan.dense_buckets)
    for tb, jb in zip(tplan.dense_buckets, jplan.dense_buckets):
        assert [_slot_tuple(s) for s in tb.slots] == \
            [_slot_tuple(s) for s in jb.slots]
        assert (tb.collective, tb.n_elems, tb.wire_dtype) == (
            jb.collective, jb.n_elems, jb.wire_dtype)
    assert [(s.kind, s.bucket_id, s.leaf_ids)
            for s in tplan.schedule.stages] == \
        [(s.kind, s.bucket_id, s.leaf_ids) for s in jplan.schedule.stages]
    assert tplan.n_collectives == jplan.n_collectives
    assert tplan.state_bytes() == jplan.state_bytes()
    for p in (1, 8, 64):
        assert tplan.wire_bytes(p) == jplan.wire_bytes(p), p
        assert tplan.buffer_bytes(p) == jplan.buffer_bytes(p), p
    cfg = get_config(arch)
    emb = cfg.vocab * cfg.d_model
    if wire.startswith("dense_reduce"):
        # the embedding is reduced densely: its whole table is in a bucket
        assert max(b.n_elems for b in tplan.dense_buckets) >= emb
    else:
        assert tplan.gather_leaf_ids
    if "int8" in wire:
        assert tplan.state_bytes() > 0
    else:
        assert tplan.state_bytes() == 0


SEAMLESS = "seamless-m4t-large-v2"


@pytest.fixture(scope="module")
def seamless():
    jmodel = jbuild_model(jget_config(SEAMLESS).reduced())
    jparams = jmodel.init(jax.random.PRNGKey(0))
    tparams = bridge.to_torch(jax.tree_util.tree_map(np.asarray, jparams),
                              "cpu")
    return jmodel, jparams, build_model(get_config(SEAMLESS).reduced()), \
        tparams


def test_seamless_config_matches_reference():
    config_fields(get_config(SEAMLESS), jget_config(SEAMLESS))
    config_fields(get_config(SEAMLESS).reduced(),
                  jget_config(SEAMLESS).reduced())
    cfg = get_config(SEAMLESS)
    assert (cfg.family, cfg.vocab, cfg.d_model, cfg.frontend.n_embeds,
            cfg.tied_embeddings) == ("audio", 256206, 1024, 1024, True)


def test_seamless_forward_matches_reference(seamless):
    jmodel, jparams, tmodel, tparams = seamless
    batch = jmake_pipeline(jmodel.cfg, 2, 12, seed=1).batch_at(0)
    assert batch["frontend"].shape == (2, 16, tmodel.cfg.d_model)
    jh, _ = jmodel.forward(jparams, {k: jnp.asarray(v)
                                     for k, v in batch.items()},
                           attn_impl="pallas")
    h = tmodel.forward(tparams, {k: _t(v) for k, v in batch.items()},
                       attn_impl="kernel")
    np.testing.assert_allclose(_np(h), _np(jh), **TOL)


@pytest.mark.parametrize("sparse_embedding", [False, True])
def test_seamless_loss_and_grads_match_jax(seamless, sparse_embedding):
    jmodel, jparams, tmodel, tparams = seamless
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
