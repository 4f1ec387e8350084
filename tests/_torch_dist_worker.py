"""Workers for the port's multi-process tests (gloo on the CPU).

Imported by the spawned processes of tests/test_torch_exchange.py
(``run``), tests/test_torch_overlap.py (``run_overlap``),
tests/test_torch_backend_world.py (``run_backends``),
tests/test_torch_zero1_world.py (``run_zero1``),
tests/test_torch_hot_swap.py (``run_broadcast``) and
tests/test_torch_trace_world.py (``run_trace``); it imports torch and the
port only.
"""
import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core import DistributedOptimizer, ExchangeConfig
from repro_torch.core.indexed_slices import IndexedSlices
from repro_torch.data import make_pipeline
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.training import (LossScaler, grad_contributions,
                                  make_scaled_train_step, make_train_step)
from repro_torch.training.microbatch import _scale_grad_tree
from repro_torch.tree import tree_flatten

VOCAB, D = 64, 8
#: int8 exchanges, each run twice in a row (the state threaded through)
INT8_CONFIGS = {
    "int8_dense_reduce": dict(sparse_as_dense=True, codec="int8"),
    "int8_sparse_gather": dict(codec="int8"),
    "int8+ef_dense_reduce": dict(sparse_as_dense=True, codec="int8+ef"),
    "int8+ef_fused": dict(sparse_as_dense=True, codec="int8+ef",
                          fusion_threshold=1 << 20),
}


def worker_grads(rank: int, exchange: int = 0):
    """A small grad-contribution tree, different on every rank and every
    exchange: a tied embedding ([IndexedSlices, dense]) and two dense
    leaves."""
    rng = np.random.default_rng(100 + rank + 1000 * exchange)
    rows = 12
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    return {
        "embedding": [IndexedSlices(
            torch.from_numpy(rng.integers(0, VOCAB, rows).astype(np.int32)),
            t(rows, D), (VOCAB, D)), t(VOCAB, D)],
        "layers": {"w": t(3, D, 5), "b": t(5)},
    }


def run(rank: int, world: int, port: int, out_dir: str) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        g = worker_grads(rank)
        results = {}
        for name, cfg in (
                ("dense_reduce", ExchangeConfig(sparse_as_dense=True,
                                                use_kernel=True)),
                ("sparse_gather", ExchangeConfig(use_kernel=True)),
                ("dense_reduce_fused", ExchangeConfig(
                    sparse_as_dense=True, use_kernel=True,
                    fusion_threshold=1 << 20))):
            avg = DistributedOptimizer(adamw(1e-3), exchange=cfg,
                                       group=dist.group.WORLD).exchange(g)[0]
            local = DistributedOptimizer(adamw(1e-3), exchange=cfg,
                                         group=None).exchange(g)[0]
            for key, tree in (("avg", avg), ("local", local)):
                results[f"{name}/{key}/embedding"] = tree["embedding"]
                results[f"{name}/{key}/w"] = tree["layers"]["w"]
                results[f"{name}/{key}/b"] = tree["layers"]["b"]
        for name, kw in INT8_CONFIGS.items():
            opt = DistributedOptimizer(
                adamw(1e-3), exchange=ExchangeConfig(use_kernel=True, **kw),
                group=dist.group.WORLD)
            state = opt.init_exchange_state(g)
            for k in range(2):
                tree, state = opt.exchange(worker_grads(rank, k),
                                           state=state)
                results[f"{name}/{k}/embedding"] = tree["embedding"]
                results[f"{name}/{k}/w"] = tree["layers"]["w"]
                results[f"{name}/{k}/b"] = tree["layers"]["b"]
        torch.save(results, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


#: the overlap modes the world-of-2 test holds against the fused step
OVERLAPS = (False, "staged", "backward")


def run_overlap(rank: int, world: int, port: int, out_dir: str) -> None:
    """Per overlap mode and wire (identity, int8+ef): two training steps
    of the reduced transformer-big, and one loss-scaled step at M = 2;
    every rank saves its final parameters, Adam moments and residuals."""
    torch.set_num_threads(2)         # two ranks share the host's cores
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        cfg = get_config("transformer-big").reduced()
        model = build_model(cfg)
        pipe = make_pipeline(cfg, 2 * world, 8, seed=0)

        def batch_at(step):
            return {k: torch.from_numpy(np.ascontiguousarray(
                v[2 * rank:2 * rank + 2]))
                for k, v in pipe.batch_at(step).items()}

        def record(tag, params, opt_state, ex_state):
            results[f"{tag}/params"] = tree_flatten(params)[0]
            results[f"{tag}/mu"] = tree_flatten(opt_state.mu)[0]
            results[f"{tag}/nu"] = tree_flatten(opt_state.nu)[0]
            results[f"{tag}/residuals"] = [
                r for r in ex_state.bucket_states
                if isinstance(r, torch.Tensor)]

        results = {}
        for codec in ("identity", "int8+ef"):
            for overlap in OVERLAPS:
                opt = DistributedOptimizer(
                    adamw(1e-3), exchange=ExchangeConfig(
                        sparse_as_dense=True, codec=codec, overlap=overlap,
                        use_kernel=True), group=dist.group.WORLD)
                step = make_train_step(model, opt, sparse_embedding=True)
                params = model.init(seed=0, device="cpu")
                opt_state = opt.init(params)
                ex = opt.init_exchange_state(grad_contributions(
                    model, params, batch_at(0), sparse_embedding=True)[0])
                for k in range(2):
                    params, opt_state, ex, _ = step(params, opt_state, ex,
                                                    batch_at(k))
                record(f"{codec}/{overlap}", params, opt_state, ex)
            for overlap in OVERLAPS:
                opt = DistributedOptimizer(
                    adamw(1e-3), exchange=ExchangeConfig(
                        sparse_as_dense=True, codec=codec, overlap=overlap,
                        use_kernel=True), group=dist.group.WORLD)
                step = make_scaled_train_step(model, opt, LossScaler(),
                                              n_microbatches=2,
                                              sparse_embedding=True)
                params = model.init(seed=0, device="cpu")
                g = grad_contributions(model, params, batch_at(0),
                                       sparse_embedding=True)[0]
                ex = opt.init_exchange_state(_scale_grad_tree(
                    g, torch.tensor(1.0)))
                params, opt_state, _, ex, m = step(
                    params, opt.init(params), LossScaler().init(device="cpu"),
                    ex, batch_at(0))
                assert not bool(m["overflow"])
                record(f"scaled/{codec}/{overlap}", params, opt_state, ex)
        torch.save(results, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


#: per backend-world exchange: (backend, ExchangeConfig keywords); each
#: runs twice in a row with the codec state threaded through
BACKEND_CONFIGS = {
    "flat/identity": ("flat", dict(sparse_as_dense=True)),
    "hierarchical/identity": ("hierarchical", dict(sparse_as_dense=True)),
    "ringsim/identity": ("ringsim", dict(sparse_as_dense=True)),
    "flat/int8+ef": ("flat", dict(sparse_as_dense=True, codec="int8+ef")),
    "hierarchical/int8+ef": ("hierarchical",
                             dict(sparse_as_dense=True, codec="int8+ef")),
    "hierarchical/int8": ("hierarchical",
                          dict(sparse_as_dense=True, codec="int8")),
    "ringsim/int8+ef": ("ringsim",
                        dict(sparse_as_dense=True, codec="int8+ef")),
    "flat/rs_identity": ("flat", dict(sparse_as_dense=True,
                                      reduce_scatter=True)),
    "flat/rs_bf16": ("flat", dict(sparse_as_dense=True, reduce_scatter=True,
                                  codec="bf16")),
    "ringsim/rs_identity": ("ringsim", dict(sparse_as_dense=True,
                                            reduce_scatter=True)),
    "ringsim/rs_bf16": ("ringsim", dict(sparse_as_dense=True,
                                        reduce_scatter=True, codec="bf16")),
    "flat/f8e4m3": ("flat", dict(sparse_as_dense=True, codec="f8e4m3")),
    "hierarchical/f8e5m2": ("hierarchical",
                            dict(sparse_as_dense=True, codec="f8e5m2")),
    "flat/sparse_gather_int8": ("flat", dict(codec="int8")),
    "hierarchical/sparse_gather_int8": ("hierarchical", dict(codec="int8")),
    "ringsim/sparse_gather_int8": ("ringsim", dict(codec="int8")),
}
#: the configs the world of 8 runs (averaging over 8 and over 2 x 4)
WORLD8_CONFIGS = ("flat/identity", "hierarchical/identity")
RING_ELEMS = 1001          # not a multiple of 2, 4 or 8: the ring pads
FP8_WIRES = {"f8e4m3": torch.float8_e4m3fn, "f8e5m2": torch.float8_e5m2}


def ring_input(rank: int, scale: float = 1.0) -> torch.Tensor:
    rng = np.random.default_rng(500 + rank)
    return torch.from_numpy(
        (rng.standard_normal(RING_ELEMS) * scale).astype(np.float32))


def run_backends(rank: int, world: int, port: int, out_dir: str) -> None:
    """Every backend over a gloo world: two exchanges in a row of each
    ``BACKEND_CONFIGS`` entry (``WORLD8_CONFIGS`` at a world of 8), with
    the comm layer's call counters and the plan's count, and each int8
    dense stage's per-hop gathered (q, scales); then (world of 4) the
    ring primitives on f32 and fp8 buffers, and one training step of
    the reduced transformer-big per backend, wire and overlap mode."""
    from repro_torch.core import backend, codecs, comm
    from repro_torch.launch.train import pod_groups
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        pods = pod_groups(rank, world)
        world_group = dist.group.WORLD

        def groups_for(be):
            return pods if be == "hierarchical" else world_group

        def levels_for(be):
            return (2, world // 2) if be == "hierarchical" else world

        results = {}
        hops = []
        reduce_hop = codecs.WireCodec.reduce_hop

        def recording(self, g_wire, g_scales, n_chunks, native_dtype):
            hops.append((g_wire.clone(), g_scales.clone(), n_chunks))
            return reduce_hop(self, g_wire, g_scales, n_chunks,
                              native_dtype)

        codecs.WireCodec.reduce_hop = recording
        names = WORLD8_CONFIGS if world == 8 else BACKEND_CONFIGS
        for name in names:
            be, kw = BACKEND_CONFIGS[name]
            opt = DistributedOptimizer(
                adamw(1e-3), exchange=ExchangeConfig(
                    backend=be, use_kernel=True, **kw),
                group=groups_for(be))
            g0 = worker_grads(rank, 0)
            state = opt.init_exchange_state(g0)
            for k in range(2):
                g = worker_grads(rank, k)
                comm.reset_calls()
                del hops[:]
                tree, state = opt.exchange(g, state=state)
                results[f"{name}/{k}/calls"] = comm.calls()
                results[f"{name}/{k}/plan_calls"] = opt.plan(
                    g).hlo_collectives(levels_for(be))
                results[f"{name}/{k}/hops"] = list(hops)
                results[f"{name}/{k}/embedding"] = tree["embedding"]
                results[f"{name}/{k}/w"] = tree["layers"]["w"]
                results[f"{name}/{k}/b"] = tree["layers"]["b"]
        codecs.WireCodec.reduce_hop = reduce_hop
        if world == 4:
            ring = backend.get_backend("ringsim")
            x = ring_input(rank)
            comm.reset_calls()
            results["ring/all_reduce"] = comm.wait(
                ring.all_reduce(x, (world_group,)))
            results["ring/reduce_scatter"] = comm.wait(ring.reduce_scatter(
                torch.cat([x, x.new_zeros(3)]), (world_group,)))
            results["ring/all_gather"] = comm.wait(
                ring.all_gather(x[:5], (world_group,)))
            results["ring/calls"] = comm.calls()
            for be in ("flat", "hierarchical", "ringsim"):
                results[f"broadcast/{be}"] = comm.wait(
                    backend.get_backend(be).broadcast(
                        x, comm.groups(groups_for(be)), root=2))
            for name, dt in FP8_WIRES.items():
                wire, _ = codecs.get_codec(name).encode(ring_input(rank,
                                                                   200.0))
                results[f"ring/{name}/pair"] = comm.ring_all_reduce(
                    wire, pods[1]).view(torch.uint8)
                results[f"ring/{name}/world"] = comm.ring_all_reduce(
                    wire, world_group).view(torch.uint8)
            _backend_steps(rank, world, groups_for, results)
        torch.save(results, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _backend_steps(rank, world, groups_for, results) -> None:
    """One training step of the reduced transformer-big per backend,
    wire (identity, int8+ef) and overlap mode; parameters, moments and
    residuals recorded."""
    cfg = get_config("transformer-big").reduced()
    model = build_model(cfg)
    pipe = make_pipeline(cfg, 2 * world, 8, seed=0)
    batch = {k: torch.from_numpy(np.ascontiguousarray(
        v[2 * rank:2 * rank + 2])) for k, v in pipe.batch_at(0).items()}
    for be in ("flat", "hierarchical", "ringsim"):
        for codec in ("identity", "int8+ef"):
            for overlap in OVERLAPS:
                opt = DistributedOptimizer(
                    adamw(1e-3), exchange=ExchangeConfig(
                        sparse_as_dense=True, codec=codec, overlap=overlap,
                        backend=be, use_kernel=True), group=groups_for(be))
                step = make_train_step(model, opt, sparse_embedding=True)
                params = model.init(seed=0, device="cpu")
                ex = opt.init_exchange_state(grad_contributions(
                    model, params, batch, sparse_embedding=True)[0])
                params, opt_state, ex, _ = step(params, opt.init(params),
                                                ex, batch)
                tag = f"step/{be}/{codec}/{overlap}"
                results[f"{tag}/state"] = (
                    tree_flatten(params)[0] + tree_flatten(opt_state.mu)[0]
                    + tree_flatten(opt_state.nu)[0]
                    + [r for r in ex.bucket_states
                       if isinstance(r, torch.Tensor)])


#: the zero1 world's exchanges: (backend, ExchangeConfig keywords), each
#: run ``ZERO1_STEPS`` steps with zero1 and without (replicated)
ZERO1_CONFIGS = {
    "identity": ("flat", dict()),
    "bf16": ("flat", dict(codec="bf16")),
    "int8": ("flat", dict(codec="int8")),
    "int8+ef": ("flat", dict(codec="int8+ef")),
    "ringsim/identity": ("ringsim", dict()),
    "ringsim/int8+ef": ("ringsim", dict(codec="int8+ef")),
}
#: the configs whose state after one step is held against the
#: reference's 4-device shard_map run
ZERO1_REFERENCE = {"identity": dict(),
                   "int8+ef/param_int8": dict(codec="int8+ef",
                                              param_codec="int8")}
ZERO1_STEPS = 3


def zero1_inputs(path: str):
    """The zero1 world's numpy inputs (params and every worker's fixed
    gradients), written by the test for both packages."""
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


def run_zero1(rank: int, world: int, port: int, out_dir: str) -> None:
    """ZeRO-1 over a gloo world: for each ``ZERO1_CONFIGS`` entry,
    ``ZERO1_STEPS`` zero1 steps and as many replicated exchange + update
    steps on the same fixed per-rank gradients (the local state's bytes,
    the comm layer's calls a step and the plan's count recorded); the
    local state after one step of each ``ZERO1_REFERENCE`` config; and a
    checkpoint resume of int8+ef after step 2 against 4 uninterrupted
    steps, through ``ShardedCheckpoint``."""
    from repro_torch.checkpoint import ShardedCheckpoint
    from repro_torch.checkpoint.checkpoint import nbytes
    from repro_torch.core import comm
    from repro_torch.optim import apply_updates
    from repro_torch.optim import zero1 as z1
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        data = zero1_inputs(f"{out_dir}/inputs.npz")
        group = dist.group.WORLD

        def fresh_params():
            return {"a": torch.from_numpy(data["a"].copy()),
                    "b": torch.from_numpy(data["b"].copy())}

        g = {"a": torch.from_numpy(data["ga"][rank].copy()),
             "b": torch.from_numpy(data["gb"][rank].copy())}
        base = adamw(lr=1e-2, weight_decay=0.01)

        def zero1_opt(be, kw):
            return DistributedOptimizer(base, exchange=ExchangeConfig(
                zero1=True, sparse_as_dense=True, backend=be,
                use_kernel=True, **kw), group=group)

        results = {}
        for name, (be, kw) in ZERO1_CONFIGS.items():
            opt = zero1_opt(be, kw)
            plan = opt.plan(g)
            params, z = fresh_params(), opt.init_zero1_state(g, fresh_params())
            ex = opt.init_exchange_state(g)
            results[f"{name}/nbytes"] = nbytes(z)
            results[f"{name}/expected_nbytes"] = z1.optimizer_state_bytes(
                plan, world)
            calls = []
            for _ in range(ZERO1_STEPS):
                comm.reset_calls()
                params, z, ex = opt.zero1_step(g, params, z,
                                               exchange_state=ex)
                calls.append(sum(comm.calls().values()))
            results[f"{name}/calls"] = calls
            results[f"{name}/plan_calls"] = plan.hlo_collectives(world)
            results[f"{name}/zero1"] = tree_flatten(params)[0]
            results[f"{name}/zero1_slots"] = [list(s) for s in z.opt_slots]
            ropt = DistributedOptimizer(base, exchange=ExchangeConfig(
                sparse_as_dense=True, backend=be, use_kernel=True, **kw),
                group=group)
            params, state = fresh_params(), base.init(fresh_params())
            ex = ropt.init_exchange_state(g)
            for _ in range(ZERO1_STEPS):
                dense, ex = ropt.exchange(g, state=ex)
                upd, state = base.update(dense, state, params)
                params = apply_updates(params, upd)
            results[f"{name}/replicated"] = tree_flatten(params)[0]
            results[f"{name}/replicated_mu"] = [
                c.narrow(0, rank * s[0].shape[0], s[0].shape[0])
                for c, s in zip(z1.bucket_layout(plan, state.mu, world),
                                z.opt_slots)]
        for name, kw in ZERO1_REFERENCE.items():
            opt = zero1_opt("flat", kw)
            params, z = fresh_params(), opt.init_zero1_state(g, fresh_params())
            ex = opt.init_exchange_state(g)
            params, z, ex = opt.zero1_step(g, params, z, exchange_state=ex)
            results[f"ref/{name}"] = (params, z, ex)
            ShardedCheckpoint(opt.plan(g), group).save(
                f"{out_dir}/global_{name}", 1, (params, z, ex))

        # resume: 2 steps, save, restore into a fresh template, 2 more
        opt = zero1_opt("flat", dict(codec="int8+ef"))
        ckpt = ShardedCheckpoint(opt.plan(g), group)

        def start():
            return (fresh_params(), opt.init_zero1_state(g, fresh_params()),
                    opt.init_exchange_state(g))

        def steps(state, n):
            for _ in range(n):
                state = opt.zero1_step(g, *state[:2],
                                       exchange_state=state[2])
            return state

        whole = steps(start(), 4)
        ckpt.save(f"{out_dir}/resume", 2, steps(start(), 2))
        resumed, at = ckpt.restore(f"{out_dir}/resume", start())
        results["resume/step"] = at
        results["resume/whole"] = whole
        results["resume/resumed"] = steps(resumed, 2)
        torch.save(results, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


#: the wires of the world-of-2 broadcast
BROADCAST_CODECS = ("identity", "int8")


def run_broadcast(rank: int, world: int, port: int, out_dir: str) -> None:
    """Every rank draws its own reduced llama3.2-1b weights (seed =
    rank) and receives rank 0's through the broadcast plan, a
    ``HotSwapStream`` and ``DistributedOptimizer.broadcast``."""
    from repro_torch.serving import HotSwapStream, broadcast_plan
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        model = build_model(get_config("llama3.2-1b").reduced())
        params = model.init(seed=rank, device="cpu")
        group = dist.group.WORLD
        results = {}
        for codec in BROADCAST_CODECS:
            plan = broadcast_plan(params, codec=codec)
            results[f"{codec}/plan"] = tree_flatten(
                plan.broadcast(params, group, root=0))[0]
            stream = HotSwapStream(plan, params, params, version=1,
                                   group=group, root=0)
            while not stream.step():
                pass
            results[f"{codec}/stream"] = tree_flatten(stream.result())[0]
            opt = DistributedOptimizer(adamw(1e-3), exchange=ExchangeConfig(
                sparse_as_dense=True, codec=codec, use_kernel=True),
                group=group)
            results[f"{codec}/optimizer"] = tree_flatten(
                opt.broadcast(params, root=0))[0]
        torch.save(results, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


#: the traced exchanges: (backend, ExchangeConfig keywords)
TRACE_CASES = {
    "identity-fused": ("flat", dict(sparse_as_dense=True)),
    "int8": ("flat", dict(sparse_as_dense=True, codec="int8")),
    "rs-ag": ("flat", dict(sparse_as_dense=True, reduce_scatter=True)),
    "ringsim": ("ringsim", dict(sparse_as_dense=True)),
    "staged": ("flat", dict(sparse_as_dense=True, codec="int8",
                            overlap="staged")),
    "f8e4m3": ("flat", dict(sparse_as_dense=True, codec="f8e4m3")),
    "hierarchical": ("hierarchical", dict(sparse_as_dense=True)),
    "hierarchical_int8": ("hierarchical", dict(sparse_as_dense=True,
                                               codec="int8")),
    "sparse_gather_int8": ("flat", dict(codec="int8")),
    "ringsim_sparse_gather": ("ringsim", dict()),
    "int8+ef": ("flat", dict(sparse_as_dense=True, codec="int8+ef")),
    "zero1_param_int8": ("flat", dict(sparse_as_dense=True, zero1=True,
                                      param_codec="int8")),
    "zero1_int8+ef": ("flat", dict(sparse_as_dense=True, zero1=True,
                                   codec="int8+ef")),
}


def flat_tensors(x) -> list:
    """Every tensor in ``x`` (dicts in key order, sequences, named tuples,
    dataclasses and ExchangeState walked)."""
    import dataclasses
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in flat_tensors(x[k])]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in flat_tensors(v)]
    if hasattr(x, "bucket_states"):
        return flat_tensors(x.bucket_states)
    if dataclasses.is_dataclass(x):
        return [t for f in dataclasses.fields(x)
                for t in flat_tensors(getattr(x, f.name))]
    return []


def bitwise(a, b) -> bool:
    ta, tb = flat_tensors(a), flat_tensors(b)
    return len(ta) == len(tb) > 0 and all(
        x.dtype == y.dtype and x.shape == y.shape
        and torch.equal(x.view(torch.uint8) if x.dtype.itemsize == 1
                        else x, y.view(torch.uint8)
                        if y.dtype.itemsize == 1 else y)
        for x, y in zip(ta, tb))


def run_trace(rank: int, world: int, port: int, out_dir: str) -> None:
    """Per ``TRACE_CASES`` entry over a gloo world: ``measure_wire``'s
    per-stage bytes beside the plan's, the caller's tensors before and
    after it, the comm counters of an untraced exchange, a traced run
    (``StepTracer.capture``) against the untraced one, and the trace
    ``capture_exchange_trace`` assembles from every rank."""
    from repro_torch.core import comm
    from repro_torch.launch.train import pod_groups
    from repro_torch.telemetry import hooks, report, trace
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        pods = pod_groups(rank, world)
        results = {}
        for name, (be, kw) in TRACE_CASES.items():
            hier = be == "hierarchical"
            levels = (2, world // 2) if hier else world
            opt = DistributedOptimizer(
                adamw(1e-3), exchange=ExchangeConfig(
                    backend=be, use_kernel=True, **kw),
                group=pods if hier else dist.group.WORLD)
            g = worker_grads(rank)
            plan = opt.plan(g)
            state = opt.init_exchange_state(g)
            if plan.config.zero1:
                rng = np.random.default_rng(9)
                params = {"embedding": torch.from_numpy(
                              rng.standard_normal((VOCAB, D)).astype(
                                  np.float32)),
                          "layers": {"w": torch.ones(3, D, 5),
                                     "b": torch.zeros(5)}}
                z = opt.init_zero1_state(g, params)
                fn = lambda gg, pp, zz, ss: opt.zero1_step(
                    gg, pp, zz, exchange_state=ss)
                args = (g, params, z, state)
            else:
                fn = lambda gg, ss: opt.exchange(gg, state=ss)
                args = (g, state)
            if name == "int8+ef":
                # a residual a previous exchange left
                args = (g, fn(worker_grads(rank, 1),
                              trace.copy_tensors(state))[1])
            before = trace.copy_tensors(args)
            rec = trace.measure_wire(fn, *args)
            r = {"recorded": rec.as_dict(),
                 "planned": {n: plan.stage_wire_bytes(s, levels)
                             for n, s in zip(plan.stage_names(),
                                             plan.schedule.stages)},
                 "planned_hops": {n: plan.stage_hop_wire_bytes(s, levels)
                                  for n, s in zip(plan.stage_names(),
                                                  plan.schedule.stages)},
                 "unchanged": bitwise(args, before),
                 "residuals": sum(isinstance(t, torch.Tensor)
                                  for t in args[-1].bucket_states)}
            comm.reset_calls()
            plain = fn(*trace.copy_tensors(args))
            r["calls"] = comm.calls()
            r["plan_calls"] = plan.hlo_collectives(levels)
            r["hooks_off"] = (hooks.wire_recorder() is None
                              and hooks.tracer() is None)
            traced = trace.StepTracer().capture(fn, *args)
            r["traced_bitwise"] = bitwise(plain, traced)
            t = trace.capture_exchange_trace(plan, fn, args, levels)
            rows = report.predicted_vs_measured(t)
            slices = [e for e in t["traceEvents"]
                      if e.get("cat") == "exchange"]
            r["trace"] = {
                "names": list(plan.stage_names()),
                "phases": {n: sorted({e["name"] for e in slices
                                      if e["args"]["stage"] == n})
                           for n in plan.stage_names()},
                "stages": sorted({e["args"]["stage"] for e in slices}),
                "min_dur": min(e["dur"] for e in t["traceEvents"]
                               if e["ph"] == "X"),
                "n_workers_traced":
                    report.summarize_trace(t)["n_workers_traced"],
                "wire_exact": report.wire_exact(rows),
                "n_workers": t["otherData"]["n_workers"]}
            r["unchanged_after_all"] = bitwise(args, before)
            results[name] = r
        torch.save(results, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()
