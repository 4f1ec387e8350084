"""llama4-scout-17b-a16e at full width against the JAX package, shapes
only (``meta`` tensors in the port, ``jax.eval_shape`` in the reference;
nothing is allocated):

  * the parameter tree: leaves, shapes, dtypes and the count,
    107,769,861,120 (6,473,180,160 at depth 2, the depth the card serves);
  * the ExchangePlan of one worker's gradient-contribution tree at batch
    8 x 256 under dense_reduce and sparse_gather with the identity and
    int8+ef wires: leaf specs, buckets, schedule, collective counts and
    the wire, buffer and state bytes exactly equal.  One expert leaf
    stacked over 48 layers holds 16 * 5120 * 8192 * 48 = 32.2 B elements,
    above 2**31, so the accounting must not wrap.
"""
import pytest

torch = pytest.importorskip("torch")

import jax                                    # noqa: E402
import jax.numpy as jnp                       # noqa: E402

from repro.configs import get_config as jget_config          # noqa: E402
from repro.core import (ExchangeConfig as JExchangeConfig,   # noqa: E402
                        exchange as jexchange)
from repro.models import build_model as jbuild_model           # noqa: E402
from repro.training.gradients import abstract_grad_contributions  # noqa: E402
from repro_torch.configs import get_config                      # noqa: E402
from repro_torch.core import ExchangeConfig, exchange           # noqa: E402
from repro_torch.models import build_model                      # noqa: E402
from repro_torch.training.gradients import grad_contributions    # noqa: E402
from repro_torch.tree import tree_flatten                       # noqa: E402
from test_torch_exchange import _slot_tuple, _spec_tuple        # noqa: E402

jax.config.update("jax_platform_name", "cpu")

SCOUT = "llama4-scout-17b-a16e"
WIRES = {
    "dense_reduce": dict(sparse_as_dense=True),
    "sparse_gather": dict(),
    "dense_reduce_int8+ef": dict(sparse_as_dense=True, codec="int8",
                                 error_feedback=True),
    "sparse_gather_int8+ef": dict(codec="int8", error_feedback=True),
}
B, S = 8, 256
EXPERT_LEAF = 48 * 16 * 5120 * 8192


@pytest.mark.parametrize("n_layers,want", [(48, 107_769_861_120),
                                           (2, 6_473_180_160)])
def test_full_width_layout_matches_reference(n_layers, want):
    cfg = get_config(SCOUT).with_(n_layers=n_layers)
    jcfg = jget_config(SCOUT).with_(n_layers=n_layers)
    tl = tree_flatten(build_model(cfg).init(device="meta"))[0]
    jparams = jax.eval_shape(jbuild_model(jcfg).init, jax.random.PRNGKey(0))
    jl = jax.tree_util.tree_leaves(jparams)
    assert [tuple(t.shape) for t in tl] == [tuple(j.shape) for j in jl]
    assert [str(t.dtype).removeprefix("torch.") for t in tl] == \
        [str(j.dtype) for j in jl]
    assert sum(t.numel() for t in tl) == want
    assert sum(int(j.size) for j in jl) == want
    ffn = build_model(cfg).init(device="meta")["layers"]["ffn"]
    assert ffn["router"].dtype == torch.float32
    assert tuple(ffn["w_gate"].shape) == (n_layers, 16, 5120, 8192)


@pytest.fixture(scope="module")
def trees():
    jmodel = jbuild_model(jget_config(SCOUT))
    jparams = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    sds = jax.ShapeDtypeStruct
    jbatch = {"tokens": sds((B, S), jnp.int32),
              "labels": sds((B, S), jnp.int32)}
    jg = abstract_grad_contributions(jmodel, jparams, jbatch,
                                     sparse_embedding=True)
    model = build_model(get_config(SCOUT))
    meta = dict(device="meta")
    tbatch = {"tokens": torch.empty(B, S, dtype=torch.int32, **meta),
              "labels": torch.empty(B, S, dtype=torch.int32, **meta)}
    tg, _, _ = grad_contributions(model, model.init(**meta), tbatch,
                                  sparse_embedding=True)
    return tg, jg


@pytest.mark.parametrize("wire", sorted(WIRES))
def test_plan_matches_reference_at_full_width(trees, wire):
    tg, jg = trees
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
    # an expert leaf alone is past 2**31 elements: no count has wrapped
    assert EXPERT_LEAF > 2 ** 31
    assert max(b.n_elems for b in tplan.dense_buckets) >= EXPERT_LEAF
    assert tplan.wire_bytes(8) >= 3 * EXPERT_LEAF * (1 if "int8" in wire
                                                     else 2)
    if "int8" in wire:
        assert tplan.state_bytes() >= 3 * EXPERT_LEAF * 4
    else:
        assert tplan.state_bytes() == 0
