"""The port's ZeRO-1 against the reference's (``repro.optim.zero1``,
the zero1 half of ``repro.core.exchange``), in-process:

  * ``ExchangeConfig(zero1=, param_codec=)`` normalised and refused as
    the reference does, with its messages (backend names mapped);
    ``sgd_momentum`` refused for want of a flat path; a zero1 plan
    refusing the grads-only exchange;
  * adamw's ``flat_update`` bitwise the tree update, and a bf16
    ``state_dtype`` storing mu and nu bitwise as the reference's adamw;
  * the plan's zero1 accounting exactly the reference's on the reduced
    transformer-big's gradient tree, for backends x codecs x param
    codecs x P in {1, 2, 4, 8}, in dense_reduce and sparse_gather, with
    ``optimizer_state_bytes`` (f32 and bf16, zero1 on and off) and the
    concrete state's bytes;
  * at a world of 1, ``zero1_step`` (local path) and ``make_train_step``
    (a gloo world of 1) bitwise the port's replicated step on the reduced
    transformer-big, parameters and Adam moments through the bucket
    layout; and 3 steps of ``zero1_step`` within ``test_torch_train.py``'s
    tolerances of the reference's jitted ``zero1_step`` on the same
    gradients, for identity, int8, int8+ef and ``param_codec="int8"``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax                                    # noqa: E402
import jax.numpy as jnp                       # noqa: E402
import numpy as np                            # noqa: E402
import torch.distributed as dist              # noqa: E402

from repro.configs import get_config as jget_config           # noqa: E402
from repro.core import (DistributedOptimizer as JDistOpt,      # noqa: E402
                        ExchangeConfig as JExchangeConfig)
from repro.core import exchange as jexchange                   # noqa: E402
from repro.core.indexed_slices import IndexedSlices as JSlices  # noqa: E402
from repro.models import build_model as jbuild_model           # noqa: E402
from repro.optim import adamw as jadamw                        # noqa: E402
from repro.optim import sgd_momentum as jsgd_momentum          # noqa: E402
from repro.optim import zero1 as jz1                           # noqa: E402
from repro.training.gradients import abstract_grad_contributions  # noqa: E402
from repro_torch import bridge                                 # noqa: E402
from repro_torch.checkpoint.checkpoint import (                # noqa: E402
    flatten_with_paths, nbytes)
from repro_torch.configs import get_config                     # noqa: E402
from repro_torch.core import DistributedOptimizer, exchange    # noqa: E402
from repro_torch.core.exchange import ExchangeConfig           # noqa: E402
from repro_torch.core.indexed_slices import IndexedSlices      # noqa: E402
from repro_torch.data import make_pipeline                     # noqa: E402
from repro_torch.launch import train                           # noqa: E402
from repro_torch.models import build_model                     # noqa: E402
from repro_torch.optim import adamw, apply_updates, sgd_momentum  # noqa: E402
from repro_torch.optim import zero1 as z1                      # noqa: E402
from repro_torch.training import make_train_step               # noqa: E402
from repro_torch.training.gradients import grad_contributions  # noqa: E402
from repro_torch.tree import tree_flatten                      # noqa: E402

jax.config.update("jax_platform_name", "cpu")

#: the port's backend names -> the reference's
BACKENDS = {"flat": "jax", "ringsim": "ringsim"}
CODECS = ["identity", "bf16", "int8", "int8+ef"]
PARAM_CODECS = ["identity", "bf16", "int8"]
MODES = {"dense_reduce": dict(sparse_as_dense=True), "sparse_gather": {}}
WORKERS = (1, 2, 4, 8)
B, S = 2, 16


def _map_backend(kw):
    if "backend" not in kw:
        return kw
    return dict(kw, backend=BACKENDS.get(kw["backend"], kw["backend"]))


def _small_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((12, 8)).astype(np.float32),
            "b": rng.standard_normal(37).astype(np.float32)}


def _both(tree):
    return (bridge.to_torch(tree, "cpu"),
            jax.tree_util.tree_map(jnp.asarray, tree))


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------

NORMALISED = [dict(zero1=True), dict(zero1=True, param_codec="bfloat16"),
              dict(zero1=True, param_codec="int8", codec="int8+ef"),
              dict(zero1=True, overlap="staged", backend="ringsim"),
              dict(zero1=True, param_codec="f8e4m3", wire_dtype="bf16")]


@pytest.mark.parametrize("kw", NORMALISED, ids=str)
def test_zero1_config_normalises_like_reference(kw):
    c, j = ExchangeConfig(**kw), JExchangeConfig(**_map_backend(kw))
    assert (c.zero1, c.param_codec, c.codec, c.overlap) == (
        j.zero1, j.param_codec, j.codec, j.overlap)
    assert c.dense_collective == j.dense_collective == "reduce_scatter"
    assert c.param_codec_obj.name == j.param_codec_obj.name


REFUSED = [
    dict(zero1=True, reduce_scatter=True),
    dict(zero1=True, backend="hierarchical"),
    dict(zero1=True, hierarchical=True),
    dict(zero1=True, overlap="backward"),
    dict(param_codec="bf16"),
    dict(param_codec="int8", codec="int8"),
    dict(zero1=True, param_codec="int8+ef"),
    dict(zero1=True, param_codec="bf16+ef"),
]


@pytest.mark.parametrize("kw", REFUSED, ids=str)
def test_zero1_config_refuses_like_reference(kw):
    with pytest.raises(ValueError) as jerr:
        JExchangeConfig(**_map_backend(kw))
    with pytest.raises(ValueError) as terr:
        ExchangeConfig(**kw)
    assert str(terr.value) == str(jerr.value).replace("'jax'", "'flat'")
    for word in ("subsumes", "hierarchical", "overlap", "param_codec",
                 "stateful"):
        if word in str(jerr.value):
            assert word in str(terr.value)


def test_zero1_requires_flat_optimizer():
    g, jg = _both(_small_tree(0))
    p, jp = _both(_small_tree(1))
    opt = DistributedOptimizer(sgd_momentum(),
                               exchange=ExchangeConfig(zero1=True))
    jopt = JDistOpt(jsgd_momentum(), exchange=JExchangeConfig(zero1=True))
    with pytest.raises(ValueError, match="flat") as jerr:
        jopt.init_zero1_state(jg, jp)
    with pytest.raises(ValueError, match="flat") as terr:
        opt.init_zero1_state(g, p)
    assert str(terr.value).split(",")[0] == str(jerr.value).split(",")[0]
    with pytest.raises(ValueError, match="flat"):
        z1.init_state(opt.plan(g), sgd_momentum(), p)


def test_zero1_plans_refuse_plain_exchange():
    g, _ = _both(_small_tree(0))
    opt = DistributedOptimizer(adamw(1e-2),
                               exchange=ExchangeConfig(zero1=True))
    plan = opt.plan(g)
    for run in (opt.exchange, opt.exchange_fused, opt.exchange_scheduled,
                lambda t: plan.execute(t, None),
                lambda t: plan.execute_fused(t, None),
                lambda t: plan.execute_scheduled(t, None)):
        with pytest.raises(ValueError, match="zero1"):
            run(g)
    with pytest.raises(ValueError, match="without zero1"):
        z1.init_state(DistributedOptimizer(adamw()).plan(g), adamw(), g)


# ---------------------------------------------------------------------------
# adamw: the flat path and state_dtype
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_flat_update_bitwise_tree_update(state_dtype):
    base = adamw(lr=3e-3, weight_decay=0.01, state_dtype=state_dtype)
    assert base.state_dtype == state_dtype
    p = bridge.to_torch(_small_tree(1), "cpu")["a"].reshape(-1)
    state = base.init(p)
    flat_state = base.flat_init(p.numel(), device="cpu")
    tree_p, flat_p = p, p
    for k in range(3):
        g = bridge.to_torch(_small_tree(10 + k), "cpu")["a"].reshape(-1)
        upd, state = base.update(g, state, tree_p)
        tree_p = apply_updates(tree_p, upd)
        flat_p, flat_state = base.flat_update(g, flat_state, flat_p,
                                              state.step)
        assert torch.equal(tree_p, flat_p)
        assert torch.equal(state.mu, flat_state[0])
        assert torch.equal(state.nu, flat_state[1])
    dt = getattr(torch, state_dtype)
    assert state.mu.dtype == flat_state[0].dtype == dt
    with pytest.raises(TypeError):
        base.flat_init(4)                  # device= is required


def test_adamw_bf16_state_matches_reference_bitwise():
    """Three steps of adamw(state_dtype="bfloat16") on the same params
    and gradients: mu and nu bitwise the reference's (the EMA math is f32
    in both, each rounded to bf16 for storage), the params within the
    f32 noise of the bias-correction pow."""
    base = adamw(2e-3, weight_decay=0.01, state_dtype="bfloat16")
    jbase = jadamw(2e-3, weight_decay=0.01, state_dtype="bfloat16")
    p, jp = _both(_small_tree(1))
    st, jst = base.init(p), jbase.init(jp)
    assert st.mu["a"].dtype == torch.bfloat16
    assert jst.mu["a"].dtype == jnp.bfloat16
    m, v = base.flat_init(6, device="cpu")
    assert m.dtype == v.dtype == torch.bfloat16
    for k in range(3):
        g, jg = _both(_small_tree(20 + k))
        upd, st = base.update(g, st, p)
        jupd, jst = jbase.update(jg, jst, jp)
        p = apply_updates(p, upd)
        jp = jax.tree_util.tree_map(lambda a, u: (a + u).astype(a.dtype),
                                    jp, jupd)
    for name in ("mu", "nu"):
        for key in ("a", "b"):
            got = getattr(st, name)[key].view(torch.int16).numpy()
            want = np.asarray(getattr(jst, name)[key]).view(np.int16)
            np.testing.assert_array_equal(got, want)
    for key in ("a", "b"):
        np.testing.assert_allclose(p[key].numpy(), np.asarray(jp[key]),
                                   atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# accounting, exactly the reference's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reduced_trees():
    """One worker's gradient-contribution tree of the reduced
    transformer-big (batch 2 x 16) in both packages, shapes only, per
    embedding mode."""
    jcfg = jget_config("transformer-big").reduced()
    jmodel = jbuild_model(jcfg)
    jparams = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))
    sds = jax.ShapeDtypeStruct
    jbatch = {"tokens": sds((B, S), jnp.int32),
              "labels": sds((B, S), jnp.int32),
              "frontend": sds((B, jcfg.frontend.n_embeds, jcfg.d_model),
                              jnp.float32)}
    jg = abstract_grad_contributions(jmodel, jparams, jbatch,
                                     sparse_embedding=True)
    cfg = get_config("transformer-big").reduced()
    model = build_model(cfg)
    meta = dict(device="meta")
    tbatch = {"tokens": torch.empty(B, S, dtype=torch.int32, **meta),
              "labels": torch.empty(B, S, dtype=torch.int32, **meta),
              "frontend": torch.empty(B, cfg.frontend.n_embeds, cfg.d_model,
                                      **meta)}
    tg, _, _ = grad_contributions(model, model.init(**meta), tbatch,
                                  sparse_embedding=True)
    return tg, jg, model.init(**meta)


def _accounting_cases():
    for be in BACKENDS:
        for codec in CODECS:
            for pc in PARAM_CODECS:
                for mode in MODES:
                    yield be, codec, pc, mode


@pytest.mark.parametrize("be,codec,pc,mode", list(_accounting_cases()),
                         ids=lambda v: str(v))
def test_zero1_accounting_equals_reference(reduced_trees, be, codec, pc,
                                           mode):
    tg, jg, meta_params = reduced_trees
    kw = dict(codec=codec, zero1=True, param_codec=pc, use_kernel=True,
              **MODES[mode])
    tplan = exchange.compile_plan(tg, ExchangeConfig(backend=be, **kw))
    jplan = jexchange.compile_plan(jg, JExchangeConfig(
        backend=BACKENDS[be], **kw))
    assert [b.collective for b in tplan.dense_buckets] == \
        [b.collective for b in jplan.dense_buckets] != []
    assert tplan.n_collectives == jplan.n_collectives
    stages = list(zip(tplan.schedule.stages, jplan.schedule.stages))
    assert [tplan.stage_collectives(t) for t, _ in stages] == \
        [jplan.stage_collectives(j) for _, j in stages]
    for p in WORKERS:
        assert tplan.wire_bytes(p) == jplan.wire_bytes(p), p
        assert tplan.hlo_collectives(p) == jplan.hlo_collectives(p), p
        for t, j in stages:
            assert tplan.stage_hop_wire_bytes(t, p) == \
                jplan.stage_hop_wire_bytes(j, p)
            assert tplan.stage_hop_ops(t, p) == jplan.stage_hop_ops(j, p)
            assert sum(tplan.stage_hop_ops(t, p)) == \
                tplan.stage_hlo_collectives(t, p)
            if t.kind == "dense":
                assert tplan.zero1_shard_elems(t, p) == \
                    jplan.zero1_shard_elems(j, p)
        for sd in ("float32", "bfloat16"):
            for zero1 in (None, True, False):
                assert z1.optimizer_state_bytes(tplan, p, sd, zero1=zero1) \
                    == jz1.optimizer_state_bytes(jplan, p, sd, zero1=zero1)
    # the concrete local state holds what the accounting says, on every
    # rank, and the global view is the ranks' slices side by side
    for p in (1, 4):
        for sd in ("float32", "bfloat16"):
            base = adamw(1e-3, state_dtype=sd)
            glob = z1.init_state(tplan, base, _zeros_like(meta_params),
                                 n_workers=p)
            for r in (0, p - 1):
                local = z1.init_local_state(tplan, base,
                                            _zeros_like(meta_params), r, p)
                z1.check_state(tplan, local, p)
                assert nbytes(local) == \
                    z1.optimizer_state_bytes(tplan, p, sd)
                sliced = z1.local_state(tplan, glob, r, p)
                assert [(k, t.shape) for k, t in flatten_with_paths(
                    sliced)] == [(k, t.shape) for k, t in
                                 flatten_with_paths(local)]


def _zeros_like(meta_tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype), meta_tree)


def test_zero1_lossy_param_codec_stores_master():
    g, _ = _both(_small_tree(0))
    p, _ = _both(_small_tree(1))
    plan = exchange.compile_plan(g, ExchangeConfig(
        sparse_as_dense=True, zero1=True, codec="int8", param_codec="bf16"))
    state = z1.init_state(plan, adamw(1e-2), p, n_workers=4)
    assert all(not isinstance(s, tuple) for s in state.param_shards)
    lossless = exchange.compile_plan(g, ExchangeConfig(
        sparse_as_dense=True, zero1=True))
    state0 = z1.init_state(lossless, adamw(1e-2), p, n_workers=4)
    assert all(isinstance(s, tuple) for s in state0.param_shards)
    assert z1.optimizer_state_bytes(plan, 4) > \
        z1.optimizer_state_bytes(lossless, 4)
    # the master shards hold the params, packed in bucket order
    for st, m, want in zip(plan.schedule.stages, state.param_shards,
                           z1.bucket_layout(plan, p, 4)):
        assert torch.equal(m, want)


# ---------------------------------------------------------------------------
# a world of 1: bitwise the replicated step; against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reduced_step_inputs():
    """The reduced transformer-big's bridged parameters (both packages
    start bitwise equal), the port's first-step gradient contributions
    and the same tree for the reference, and 3 batches."""
    jcfg = jget_config("transformer-big").reduced()
    jparams = jbuild_model(jcfg).init(jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    cfg = get_config("transformer-big").reduced()
    model = build_model(cfg)
    pipe = make_pipeline(cfg, B, S, seed=0)
    batches = [{k: torch.from_numpy(v) for k, v in pipe.batch_at(s).items()}
               for s in range(3)]
    params = bridge.to_torch(np_params, "cpu")
    g = grad_contributions(model, params, batches[0],
                           sparse_embedding=True)[0]
    return model, np_params, g, _to_jax(g), batches


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_jax(c) for c in tree]
    if isinstance(tree, IndexedSlices):
        return JSlices(jnp.asarray(tree.indices.numpy()),
                       jnp.asarray(tree.values.numpy()), tree.dense_shape)
    return jnp.asarray(tree.detach().numpy())


#: zero1 configs run at a world of 1: (ExchangeConfig keywords, bitwise
#: against the replicated step of the same keywords without zero1)
WORLD1 = {
    "identity": (dict(), True),
    "int8": (dict(codec="int8"), True),
    "int8+ef": (dict(codec="int8+ef"), True),
    "param_int8": (dict(param_codec="int8"), False),
}


def _replicated(base, cfg_kw, g, params, steps):
    opt = DistributedOptimizer(base, exchange=ExchangeConfig(**cfg_kw))
    state, ex = base.init(params), opt.init_exchange_state(g)
    for _ in range(steps):
        dense, ex = opt.exchange(g, state=ex)
        upd, state = base.update(dense, state, params)
        params = apply_updates(params, upd)
    return params, state, ex


@pytest.mark.parametrize("name", sorted(WORLD1))
def test_zero1_step_world_of_one(reduced_step_inputs, name):
    """``zero1_step`` on the local path, 3 steps of the same gradients:
    bitwise the replicated exchange + update for lossless param wires
    (parameters, moments through the bucket layout, residuals), and
    within the reference's ``zero1_step`` by the tolerances of
    ``tests/test_torch_train.py``."""
    _, np_params, g, jg, _ = reduced_step_inputs
    kw, bitwise = WORLD1[name]
    kw = dict(kw, sparse_as_dense=True, use_kernel=True)
    base = adamw(1e-3, weight_decay=0.01)
    opt = DistributedOptimizer(base, exchange=ExchangeConfig(zero1=True,
                                                             **kw))
    plan = opt.plan(g)
    params = bridge.to_torch(np_params, "cpu")
    z, ex = opt.init_zero1_state(g, params), opt.init_exchange_state(g)
    assert nbytes(z) == z1.optimizer_state_bytes(plan, 1)
    for _ in range(3):
        params, z, ex = opt.zero1_step(g, params, z, exchange_state=ex)
    assert int(z.step) == 3

    if bitwise:
        rp, rstate, rex = _replicated(base, kw, g,
                                      bridge.to_torch(np_params, "cpu"), 3)
        for a, b in zip(tree_flatten(params)[0], tree_flatten(rp)[0]):
            assert torch.equal(a, b)
        for k, st in enumerate(plan.schedule.stages):
            for slot, tree in zip(z.opt_slots[k], (rstate.mu, rstate.nu)):
                assert torch.equal(slot,
                                   z1.bucket_layout(plan, tree)[k])
        for a, b in zip(ex.bucket_states, rex.bucket_states):
            assert (a == () == b) or torch.equal(a, b)

    jbase = jadamw(1e-3, weight_decay=0.01)
    jopt = JDistOpt(jbase, exchange=JExchangeConfig(zero1=True, **kw))
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    jz = jopt.init_zero1_state(jg, jp)
    jex = jopt.init_exchange_state(jg)
    jstep = jax.jit(lambda p, z_, e: jopt.zero1_step(jg, p, z_,
                                                     exchange_state=e))
    for _ in range(3):
        jp, jz, jex = jstep(jp, jz, jex)
    # tests/test_torch_train.py's parameter tolerance: an element whose
    # gradient cancels to the f32 noise floor may step the other way
    flip_bound = 2 * 3 * 1e-3
    for t, j in zip(tree_flatten(params)[0],
                    jax.tree_util.tree_leaves(jp)):
        diff = np.abs(t.numpy() - np.asarray(j))
        assert (diff > 1e-5).mean() <= 1e-3
        assert diff.max() <= flip_bound
    for k in range(plan.schedule.n_stages):
        mu, jmu = z.opt_slots[k][0].numpy(), np.asarray(jz.opt_slots[k][0])
        assert mu.shape == jmu.shape
        # an int8 rounding that flips moves an element by one step
        q_step = (float(np.abs(np.asarray(jex.bucket_states[k])).max())
                  * 2.5 if name == "int8+ef" else 0.0)
        diff = np.abs(mu - jmu)
        assert diff.max() <= max(q_step, 1e-5 + 1e-4 * np.abs(jmu).max())
        assert (diff > 1e-5 + 1e-4 * np.abs(jmu)).mean() <= 1e-3
        if not isinstance(jz.param_shards[k], tuple):
            np.testing.assert_allclose(z.param_shards[k].numpy(),
                                       np.asarray(jz.param_shards[k]),
                                       atol=flip_bound)


@pytest.mark.parametrize("codec", ["identity", "int8+ef"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_zero1_train_step_bitwise_replicated(reduced_step_inputs, codec,
                                             mode):
    """``make_train_step`` under zero1, through a gloo world of 1 (the
    collectives issued at P = 1), 3 steps on the reduced transformer-big:
    parameters, losses, moments (through the bucket layout) and
    residuals bitwise the replicated step's."""
    model, np_params, _, _, batches = reduced_step_inputs
    device = train.resolve_device("cpu")
    _, world, created = train.init_distributed(device)
    assert world == 1
    try:
        runs = {}
        for zero1 in (False, True):
            opt = DistributedOptimizer(adamw(1e-3), exchange=ExchangeConfig(
                codec=codec, zero1=zero1, use_kernel=True, **MODES[mode]),
                group=dist.group.WORLD)
            step = make_train_step(model, opt, sparse_embedding=True)
            params = bridge.to_torch(np_params, "cpu")
            g = grad_contributions(model, params, batches[0],
                                   sparse_embedding=True)[0]
            state = (opt.init_zero1_state(g, params) if zero1
                     else opt.init(params))
            ex, losses = opt.init_exchange_state(g), []
            for b in batches:
                params, state, ex, m = step(params, state, ex, b)
                losses.append(float(m["loss"]))
                assert int(m["exchange_stages"]) == \
                    opt.plan(g).schedule.n_stages
            runs[zero1] = (params, state, ex, losses, opt.plan(g))
    finally:
        if created:
            dist.destroy_process_group()
    (rp, rs, rex, rl, _), (zp, zs, zex, zl, plan) = runs[False], runs[True]
    assert rl == zl
    for a, b in zip(tree_flatten(rp)[0], tree_flatten(zp)[0]):
        assert torch.equal(a, b)
    for k in range(plan.schedule.n_stages):
        assert torch.equal(zs.opt_slots[k][0],
                           z1.bucket_layout(plan, rs.mu)[k])
        assert torch.equal(zs.opt_slots[k][1],
                           z1.bucket_layout(plan, rs.nu)[k])
    for a, b in zip(rex.bucket_states, zex.bucket_states):
        assert (a == () == b) or torch.equal(a, b)
