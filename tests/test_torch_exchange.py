"""The port's ExchangePlan against ``repro.core.exchange``.

  * plan parity at full-width transformer-big shapes: the same buckets,
    slots, wire dtypes, schedule and byte accounting, exactly (the port's
    tree from ``meta`` tensors, the reference's from
    ``abstract_grad_contributions``; nothing is allocated);
  * exchanged values on the reduced config, local path, within 1e-5,
    with the densify kernel path on both sides;
  * averaging over a gloo world of 2 started by torch.multiprocessing,
    for the identity wire and for int8 with and without error feedback.
"""
import pytest

torch = pytest.importorskip("torch")

import jax                                    # noqa: E402
import jax.numpy as jnp                       # noqa: E402
import numpy as np                            # noqa: E402

from repro.configs import get_config as jget_config          # noqa: E402
from repro.core import (DistributedOptimizer as JDistOpt,    # noqa: E402
                        ExchangeConfig as JExchangeConfig,
                        exchange as jexchange)
from repro.core.indexed_slices import IndexedSlices as JSlices  # noqa: E402
from repro.data import make_pipeline as jmake_pipeline         # noqa: E402
from repro.models import build_model as jbuild_model           # noqa: E402
from repro.optim import adamw as jadamw                        # noqa: E402
from repro.training.gradients import (                          # noqa: E402
    abstract_grad_contributions, grad_contributions as jgrad_contributions)
from repro_torch import bridge                                  # noqa: E402
from repro_torch.configs import get_config                      # noqa: E402
from repro_torch.core import (DistributedOptimizer, ExchangeConfig,  # noqa: E402
                              exchange)
from repro_torch.core.indexed_slices import IndexedSlices as TSlices  # noqa: E402
from repro_torch.models import build_model                      # noqa: E402
from repro_torch.optim import adamw                             # noqa: E402
from repro_torch.training.gradients import grad_contributions    # noqa: E402
from repro_torch.tree import tree_flatten                       # noqa: E402

import _torch_dist_worker                                       # noqa: E402
from _torch_world import spawn_world                             # noqa: E402

jax.config.update("jax_platform_name", "cpu")

CONFIGS = {
    "dense_reduce": dict(sparse_as_dense=True),
    "sparse_gather": dict(),
    "alg2": dict(algorithm="proposed_algorithm2"),
    "int8": dict(sparse_as_dense=True, codec="int8"),
    "int8+ef": dict(sparse_as_dense=True, codec="int8",
                    error_feedback=True),
    "f16": dict(sparse_as_dense=True, codec="f16"),
    "bf16+ef": dict(sparse_as_dense=True, codec="bf16+ef"),
    "sparse_gather_int8": dict(codec="int8"),
    "sparse_gather_f16+ef": dict(codec="f16", error_feedback=True),
}
THRESHOLDS = [None, 128 * 1024 * 1024]


@pytest.fixture(scope="module")
def full_width_trees():
    """One worker's gradient-contribution tree for full-width
    transformer-big, batch 8 x 256, in both packages, shapes only."""
    b, s = 8, 256
    jcfg = jget_config("transformer-big")
    jmodel = jbuild_model(jcfg)
    jparams = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    sds = jax.ShapeDtypeStruct
    jbatch = {"tokens": sds((b, s), jnp.int32),
              "labels": sds((b, s), jnp.int32),
              "frontend": sds((b, jcfg.frontend.n_embeds, jcfg.d_model),
                              jnp.float32)}
    jg = abstract_grad_contributions(jmodel, jparams, jbatch,
                                     sparse_embedding=True)
    cfg = get_config("transformer-big")
    model = build_model(cfg)
    meta = dict(device="meta")
    tbatch = {"tokens": torch.empty(b, s, dtype=torch.int32, **meta),
              "labels": torch.empty(b, s, dtype=torch.int32, **meta),
              "frontend": torch.empty(b, cfg.frontend.n_embeds, cfg.d_model,
                                      **meta)}
    tg, _, _ = grad_contributions(model, model.init(**meta), tbatch,
                                  sparse_embedding=True)
    return tg, jg


def _spec_tuple(spec):
    if isinstance(spec, (exchange.DenseSpec, jexchange.DenseSpec)):
        return ("dense", tuple(spec.shape), spec.dtype)
    return ("sparse", spec.rows, tuple(spec.dense_shape), spec.dtype,
            spec.index_dtype)


def _slot_tuple(s):
    return (s.leaf_idx, s.offset, s.size, tuple(s.shape), s.dtype)


@pytest.mark.parametrize("threshold", THRESHOLDS)
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plan_matches_reference_at_full_width(full_width_trees, name,
                                              threshold):
    tg, jg = full_width_trees
    tplan = exchange.compile_plan(tg, ExchangeConfig(
        fusion_threshold=threshold, use_kernel=True, **CONFIGS[name]))
    jplan = jexchange.compile_plan(jg, JExchangeConfig(
        fusion_threshold=threshold, use_kernel=True, **CONFIGS[name]))
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
    assert tplan.n_buckets == jplan.n_buckets
    assert tplan.config.codec == jplan.config.codec
    assert tplan.n_collectives == jplan.n_collectives
    assert [tplan.stage_collectives(s) for s in tplan.schedule.stages] == \
        [jplan.stage_collectives(s) for s in jplan.schedule.stages]
    assert tplan.dense_bytes == jplan.dense_bytes
    assert tplan.state_bytes_per_stage() == jplan.state_bytes_per_stage()
    assert tplan.state_bytes() == jplan.state_bytes()
    for p in (1, 4, 8, 64):
        assert tplan.buffer_bytes(p) == jplan.buffer_bytes(p)
        assert tplan.wire_bytes(p) == jplan.wire_bytes(p)
    if "int8" in name:
        assert tplan.n_collectives == 2 * tplan.schedule.n_stages
        if threshold is None:
            assert tplan.n_collectives == 32
    if name == "int8+ef" and threshold is None:
        assert tplan.state_bytes() == 641_462_272


def test_plan_is_cached_and_rejects_other_trees(full_width_trees):
    tg, _ = full_width_trees
    cfg = ExchangeConfig(sparse_as_dense=True)
    plan = exchange.compile_plan(tg, cfg)
    assert exchange.compile_plan(tg, cfg) is plan
    with pytest.raises(ValueError, match="structure"):
        plan.execute_fused({"embedding": torch.zeros(2, 2)}, None)
    with pytest.raises(ValueError):
        ExchangeConfig(algorithm="nope")


def _j_to_t(tree):
    """Reference grad tree -> the port's (IndexedSlices rebuilt)."""
    leaves, treedef = jax.tree_util.tree_flatten(
        tree, is_leaf=lambda x: isinstance(x, (list, JSlices)))

    def conv(x):
        if isinstance(x, list):
            return [conv(c) for c in x]
        if isinstance(x, JSlices):
            return TSlices(bridge.array_to_tensor(x.indices, "cpu"),
                           bridge.array_to_tensor(x.values, "cpu"),
                           tuple(x.dense_shape))
        return bridge.array_to_tensor(x, "cpu")

    return jax.tree_util.tree_unflatten(treedef, [conv(x) for x in leaves])


@pytest.fixture(scope="module")
def reduced_grads():
    jcfg = jget_config("transformer-big").reduced()
    jmodel = jbuild_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    batch = jmake_pipeline(jcfg, 2, 16, seed=1).batch_at(0)
    jg, _, _ = jgrad_contributions(
        jmodel, jparams, {k: jnp.asarray(v) for k, v in batch.items()},
        sparse_embedding=True)
    return jg


@pytest.mark.parametrize("threshold", THRESHOLDS)
@pytest.mark.parametrize("name", ["dense_reduce", "sparse_gather"])
def test_local_exchange_matches_reference(reduced_grads, name, threshold):
    jg = reduced_grads
    kw = dict(fusion_threshold=threshold, use_kernel=True, **CONFIGS[name])
    want = JDistOpt(jadamw(1e-3), exchange=JExchangeConfig(**kw)).exchange(jg)
    got = DistributedOptimizer(adamw(1e-3), exchange=ExchangeConfig(**kw),
                               group=None).exchange(_j_to_t(jg))[0]
    tl, jl = tree_flatten(got)[0], jax.tree_util.tree_leaves(want)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        assert tuple(t.shape) == tuple(j.shape)
        assert str(t.dtype) == f"torch.{j.dtype}"
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5)


@pytest.fixture(scope="module")
def gloo_world_of_two(tmp_path_factory):
    """Both ranks' exchange results from one gloo world of 2."""
    out = tmp_path_factory.mktemp("gloo2")
    spawn_world(_torch_dist_worker.run, 2, out, timeout=120)
    return [torch.load(out / f"rank{r}.pt") for r in range(2)]


def test_gloo_world_of_two_averages(gloo_world_of_two):
    res = gloo_world_of_two
    for name in ("dense_reduce", "sparse_gather", "dense_reduce_fused"):
        for leaf in ("embedding", "w", "b"):
            mean = (res[0][f"{name}/local/{leaf}"]
                    + res[1][f"{name}/local/{leaf}"]) / 2
            for r in range(2):
                np.testing.assert_allclose(
                    res[r][f"{name}/avg/{leaf}"].numpy(), mean.numpy(),
                    rtol=1e-6, atol=1e-6)


def test_fusion_plan_and_pack_roundtrip_match_reference():
    from repro.core import fusion as jfusion
    from repro_torch.core import fusion
    rng = np.random.default_rng(0)
    shapes = {"a": (7, 5), "b": (64,), "c": {"d": (3, 4, 2), "e": (1,)},
              "f": (16, 16)}

    def make(spec):
        if isinstance(spec, dict):
            return {k: make(v) for k, v in spec.items()}
        return rng.standard_normal(spec).astype(np.float32)

    arrays = make(shapes)
    tree = jax.tree_util.tree_map(torch.from_numpy, arrays)
    for threshold in (0, 300, 1 << 20):
        plan = fusion.plan_fusion(tree, threshold_bytes=threshold)
        jplan = jfusion.plan_fusion(
            jax.tree_util.tree_map(jnp.asarray, arrays),
            threshold_bytes=threshold)
        assert [[_slot_tuple(s) for s in b] for b in plan.buckets] == \
            [[_slot_tuple(s) for s in b] for b in jplan.buckets]
        bufs = fusion.pack(tree, plan, dtype=torch.bfloat16)
        assert all(b.dtype == torch.bfloat16 and b.dim() == 1 for b in bufs)
        back = fusion.unpack(fusion.pack(tree, plan), plan)
        for t, a in zip(tree_flatten(back)[0],
                        jax.tree_util.tree_leaves(arrays)):
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), a)
        narrowed = fusion.unpack(bufs, plan)       # dtype restored
        assert all(t.dtype == torch.float32
                   for t in tree_flatten(narrowed)[0])


def test_bridge_roundtrip_is_bitwise():
    arrays = {"w": np.arange(6, dtype=np.float32).reshape(2, 3) / 7,
              "n": {"bf": np.asarray(jnp.linspace(-3, 3, 11,
                                                  dtype=jnp.bfloat16))}}
    t = bridge.to_torch(arrays, "cpu")
    assert t["n"]["bf"].dtype == torch.bfloat16
    back = bridge.to_numpy(t)
    np.testing.assert_array_equal(back["w"], arrays["w"])
    np.testing.assert_array_equal(back["n"]["bf"],
                                  arrays["n"]["bf"].astype(np.float32))


def test_bridge_takes_no_default_device():
    """The tree lands on the device the caller names, and a call that
    names none raises: the bridge never puts weights on the CPU unasked."""
    arrays = {"w": np.ones((2, 3), np.float32),
              "bf": np.asarray(jnp.ones(4, dtype=jnp.bfloat16))}
    with pytest.raises(TypeError):
        bridge.to_torch(arrays)
    with pytest.raises(TypeError):
        bridge.array_to_tensor(arrays["w"])
    meta = bridge.to_torch(arrays, "meta")
    assert {t.device.type for t in meta.values()} == {"meta"}
    assert meta["bf"].dtype == torch.bfloat16
    assert bridge.array_to_tensor(arrays["w"], "meta").device.type == "meta"


def test_distributed_optimizer_update_is_exchange_then_base(reduced_grads):
    g = _j_to_t(reduced_grads)
    params = jax.tree_util.tree_map(
        lambda x: torch.zeros(x.shape),
        jax.tree_util.tree_map(lambda x: x[1] if isinstance(x, list) else x,
                               reduced_grads,
                               is_leaf=lambda x: isinstance(x, list)))
    opt = DistributedOptimizer(adamw(1e-2), exchange=ExchangeConfig(
        sparse_as_dense=True, use_kernel=True))
    state = opt.init(params)
    u1, s1 = opt.update(g, state, params)
    u2, s2 = opt.base.update(opt.exchange(g)[0], state, params)
    for a, b in zip(tree_flatten(u1)[0], tree_flatten(u2)[0]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert int(s1.step) == int(s2.step) == 1


def _to_jax(tree):
    """The worker's torch grad tree -> the reference's."""
    def conv(x):
        if isinstance(x, list):
            return [conv(c) for c in x]
        if isinstance(x, TSlices):
            return JSlices(jnp.asarray(x.indices.numpy()),
                           jnp.asarray(x.values.numpy()), x.dense_shape)
        return jnp.asarray(x.numpy())
    return {"embedding": conv(tree["embedding"]),
            "layers": {k: conv(v) for k, v in tree["layers"].items()}}


@pytest.mark.parametrize("name", sorted(_torch_dist_worker.INT8_CONFIGS))
def test_gloo_world_of_two_int8_matches_reference(gloo_world_of_two, name):
    """Every rank's result of an int8 exchange over gloo is the mean over
    ranks of the reference codec's decode of that rank's own gradients:
    each worker quantises against its own scale, and error feedback
    keeps a per-rank residual.  Two exchanges in a row; atol 1e-6 covers
    the f32 sum order of the decode-sum and of densify."""
    kw = dict(use_kernel=True, **_torch_dist_worker.INT8_CONFIGS[name])
    per_rank = []
    for r in range(2):
        jopt = JDistOpt(jadamw(1e-3), exchange=JExchangeConfig(**kw))
        g0 = _to_jax(_torch_dist_worker.worker_grads(r, 0))
        state = jopt.init_exchange_state(g0)
        outs = []
        for k in range(2):
            tree, state = jopt.exchange(
                _to_jax(_torch_dist_worker.worker_grads(r, k)), state=state)
            outs.append({"embedding": tree["embedding"],
                         "w": tree["layers"]["w"], "b": tree["layers"]["b"]})
        per_rank.append(outs)
    for k in range(2):
        for leaf in ("embedding", "w", "b"):
            mean = (np.asarray(per_rank[0][k][leaf])
                    + np.asarray(per_rank[1][k][leaf])) / 2
            for r in range(2):
                np.testing.assert_allclose(
                    gloo_world_of_two[r][f"{name}/{k}/{leaf}"].numpy(), mean,
                    rtol=0, atol=1e-6)
