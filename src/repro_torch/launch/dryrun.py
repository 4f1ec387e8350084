"""Dry run of the production configurations (``repro.launch.dryrun``,
the parts that are not XLA's).

The reference lowers and compiles every (arch x shape x mesh) on 512
emulated TPU devices, GSPMD partitioning each step.  The port runs the
same steps once, with no memory and no device, every aten op dispatched
and counted (``launch.flops``), in one of two modes.  ``--mode meta``
(the default) runs a step unpartitioned on ``meta`` tensors at the
global shape.  ``--mode gspmd`` (recorded as ``"dtensor"``) runs it
partitioned: every argument a meta ``DTensor`` laid out over the mesh's
``DeviceMesh``, the step under ``activation_sharding`` (see
``launch.partitioned``).  The mesh comes from ``launch.mesh``, the
per-leaf layouts from ``launch.sharding``, and the ``DeviceMesh`` is
built over a fake world of the mesh's size in this one process
(``torch.distributed``'s ``fake`` backend, where a collective returns at
once and leaves its output unwritten).

  * ``build_step`` builds the train step (loss with remat, backward and
    AdamW under Noam with the paper's exchange, ``sparse_as_dense`` and
    ``proposed_algorithm2``), the prefill step (forward, then the head on
    the last position) or the serve step (``decode_step``), with its
    arguments and their layouts.
  * ``analyse`` counts the step: ``flops_global_jaxpr`` (the reference's
    key, here the dispatch count), per-device FLOPs and bytes, the
    per-device argument and output bytes, and for a train step the
    data-parallel exchange's wire bytes (``plan.wire_bytes`` over the
    data axes, exact).  The roofline terms come only with a ``profile``.
    Unpartitioned, the counts are of the global step (per device: over
    the chip count) and the argument and output bytes the exact sums of
    the layouts' shard shapes; ``collective_bytes_per_device`` holds the
    exchange alone, and ``model_axis_collectives`` and
    ``memory.temp_bytes`` are null: no collective but the exchange's is
    dispatched, and no shard is live.  Partitioned, the counts are rank
    0's (``flops_global_jaxpr`` = n_chips x that: ranks are alike up to
    uneven tails, and rank 0 holds the largest shards), the collectives
    DTensor dispatched are reported by kind (``collective_counts``,
    ``collective_bytes_per_device``: each call's result bytes, which
    ``collective_total_bytes`` sums; the exchange's entry is the plan's
    account of the data-axis reduction among them and is not added), and
    by mesh dim (``model_axis_collectives``, ``data_axis_collectives``);
    ``memory.temp_bytes`` is the peak of the local storages the step
    creates (its outputs included, its arguments not): the counterpart
    of XLA's ``temp_size_in_bytes``, not claimed equal to it.  In both
    modes ``generated_code_bytes`` is null: nothing is compiled.
  * ``audit_exchange_plan`` runs the plan-scheduled exchange on a real
    gradient tree in a fake world of ``n_workers`` and holds the plan's
    collective count and wire bytes to the comm layer's counters and the
    wire recorder; ``audit_exchange_gspmd`` (``--audit-mode gspmd``)
    reports the collectives DTensor chooses for the data-parallel
    reduction beside the plan's.
  * ``model_flops`` / ``param_counts``: 6·N_active·D from the config.

On a CPU mesh DTensor moves a shard from one dim to another with an
all-gather and a chunk (gloo has no all-to-all), billed as an all-gather
here; a CUDA mesh sends it as an all-to-all.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b \\
      --shape train_4k [--mode gspmd] [--multi-pod] [--profile tpu] \\
      [--out out.json] --device cpu
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch \\
      transformer-big --audit-exchange [--audit-mode gspmd] --device cpu \\
      [--codec int8 ...]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import sys
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs import (ARCH_IDS, INPUT_SHAPES, InputShape,
                                 get_config)
from repro_torch.core import (DistributedOptimizer, ExchangeConfig,
                              available_backends, available_codecs, comm,
                              exchange)
from repro_torch.launch import flops as flops_lib
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import partitioned as part_lib
from repro_torch.launch import sharding as shard_lib
from repro_torch.launch import specs as specs_lib
from repro_torch.models import build_model
from repro_torch.optim import adamw, noam_schedule
from repro_torch.training import make_train_step
from repro_torch.training.gradients import abstract_grad_contributions
from repro_torch.tree import tree_flatten, tree_unflatten

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
SWEEP_DIR = os.path.join(REPO, "experiments", "dryrun_torch")
META = torch.device("meta")
#: the reference's attention impl names, as the port calls them
ATTN_NAMES = {"xla_chunked": "chunked", "xla": "ref", "pallas": "kernel"}


@contextlib.contextmanager
def fake_world(n: int):
    """A ``torch.distributed`` world of ``n`` ranks in this process (this
    one rank 0) on the ``fake`` backend: every collective returns at once
    and leaves its outputs as they were.  A world already up is kept."""
    if dist.is_initialized():
        yield
        return
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


@dataclasses.dataclass
class DryStep:
    """A step on meta tensors: ``fn(*args)``, each argument's layout
    (a spec tree, ``None`` for one that holds no tensor of the step's
    state), and ``out_specs(outputs) -> (list of outputs, list of their
    layouts)``."""
    fn: Callable
    args: Tuple[Any, ...]
    arg_specs: Tuple[Any, ...]
    out_specs: Callable[[Any], Any]
    mesh: mesh_lib.MeshSpec
    kind: str
    plan: Optional[exchange.ExchangePlan] = None
    dp_workers: int = 1
    dp_axes: Tuple[str, ...] = ()
    partitioned: bool = False


def _input_shape(shape) -> InputShape:
    return INPUT_SHAPES[shape] if isinstance(shape, str) else shape


#: the reference's mode name -> the port's (recorded in the result)
MODES = {"meta": "meta", "gspmd": "dtensor"}


def build_step(arch: str, shape_name, multi_pod: bool,
               mode: str = "meta", fsdp: bool = True, pure_dp: bool = False,
               zero1: bool = False, attn_impl: str = "chunked",
               mesh_override: Optional[mesh_lib.MeshSpec] = None,
               ssm_chunk: Optional[int] = None,
               moe_decode: str = "dropless",
               loss_chunk: int = 512,
               remat: bool = True) -> Tuple[DryStep, Dict[str, Any]]:
    """The step of ``shape_name`` (an ``INPUT_SHAPES`` name, or an
    ``InputShape``) on meta tensors at the global shape, with the
    reference's layouts (``lower_step``'s arguments).  ``mode`` "meta"
    runs it unpartitioned; "gspmd" (the reference's name, recorded as
    "dtensor") runs it partitioned, on DTensors over the mesh
    (``analyse`` distributes the arguments).  The train step rematerialises its
    blocks, as the reference's does; ``remat=False`` turns that off.
    Returns ``(step, meta)``."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {sorted(MODES)}, got "
                         f"{mode!r}")
    part = MODES[mode] == "dtensor"
    attn_impl = ATTN_NAMES.get(attn_impl, attn_impl)
    cfg = get_config(arch)
    if ssm_chunk and cfg.ssm is not None:
        cfg = cfg.with_(ssm=dataclasses.replace(cfg.ssm, chunk=ssm_chunk))
    shape = _input_shape(shape_name)
    model = build_model(cfg)
    mesh = (mesh_override if mesh_override is not None
            else mesh_lib.make_production_mesh(multi_pod=multi_pod))
    sizes = mesh.axis_sizes()

    params = specs_lib.params_structs(cfg)
    # weights over `model` only (Megatron col/row rules) unless a
    # model-only shard would not fit HBM (> 8 GB a device) or training
    param_bytes = sum(t.numel() * t.element_size()
                      for t in tree_flatten(params)[0])
    weights_fsdp = fsdp and (shape.kind == "train"
                             or param_bytes / sizes.get("model", 1) > 8e9)
    p_shard = (shard_lib.replicated(params, mesh) if pure_dp else
               shard_lib.params_shardings(params, mesh, fsdp=weights_fsdp))
    dp_axes = (tuple(mesh.axis_names) if pure_dp
               else mesh_lib.data_axes(mesh))
    meta: Dict[str, Any] = dict(arch=arch, shape=shape.name,
                                mesh=list(mesh.shape),
                                axes=list(mesh.axis_names),
                                mode=MODES[mode],
                                pure_dp=pure_dp, attn_impl=attn_impl)

    if shape.kind == "train":
        opt = DistributedOptimizer(
            adamw(noam_schedule(cfg.d_model)),
            exchange=ExchangeConfig(sparse_as_dense=True,
                                    algorithm="proposed_algorithm2"))
        loss_kw = dict(attn_impl=attn_impl, loss_chunk=loss_chunk,
                       remat=remat)
        step = (part_lib.make_partitioned_train_step(model, opt, dp_axes,
                                                     **loss_kw) if part
                else make_train_step(model, opt, sparse_embedding=False,
                                     **loss_kw))
        batch = specs_lib.input_specs(cfg, shape)
        grads = abstract_grad_contributions(model, params, batch)
        opt_state = opt.init(params)
        ex_state = opt.init_exchange_state(grads, device=META)
        o_shard = (shard_lib.replicated(opt_state, mesh)
                   if (pure_dp and not zero1)
                   else shard_lib.params_shardings(opt_state, mesh,
                                                   fsdp=fsdp))
        b_shard = shard_lib.batch_shardings(batch, mesh, dp_axes=dp_axes)

        def train_outputs(out):
            new_p, new_o, _, metrics = out
            return [new_p, new_o, metrics], [
                p_shard, o_shard, shard_lib.replicated(metrics, mesh)]
        return DryStep(step, (params, opt_state, ex_state, batch),
                       (p_shard, o_shard, None, b_shard), train_outputs,
                       mesh, "train", plan=opt.plan(grads),
                       dp_workers=math.prod(sizes[a] for a in dp_axes),
                       dp_axes=dp_axes, partitioned=part), meta

    if shape.kind == "prefill":
        batch = specs_lib.input_specs(cfg, shape)
        b_shard = shard_lib.batch_shardings(batch, mesh)

        def prefill_step(params, batch):
            h = model.forward(params, batch, attn_impl=attn_impl)
            return model.head(params, h[:, -1:])

        def prefill_outputs(logits):
            return logits, shard_lib.batch_shardings(logits, mesh)
        return DryStep(part_lib.partitioned_call(prefill_step, dp_axes) if part
                       else prefill_step, (params, batch),
                       (p_shard, b_shard), prefill_outputs, mesh, "prefill",
                       dp_axes=dp_axes, partitioned=part), meta

    toks, cache, window, ring = specs_lib.decode_specs(cfg, shape)
    enc = toks.pop("enc", None)
    c_shard = shard_lib.cache_shardings(cache, mesh, shape.global_batch)
    t_shard = shard_lib.batch_shardings(toks, mesh)
    meta.update(window=window, ring=ring)

    def serve_step(params, cache, toks, enc=None):
        return model.decode_step(params, cache, toks["tokens"], enc=enc,
                                 window=window, attn_impl=attn_impl,
                                 ring=ring, moe_mode=moe_decode)

    def serve_outputs(out):
        logits, new_cache = out
        return [logits, new_cache], [shard_lib.batch_shardings(logits, mesh),
                                     c_shard]
    args, arg_specs = (params, cache, toks), (p_shard, c_shard, t_shard)
    if enc is not None:
        args += (enc,)
        arg_specs += (shard_lib.batch_shardings(enc, mesh),)
    return DryStep(part_lib.partitioned_call(serve_step, dp_axes) if part
                   else serve_step, args, arg_specs, serve_outputs, mesh,
                   "decode", dp_axes=dp_axes, partitioned=part), meta


def _debug_counts(comm_mode) -> Dict[str, int]:
    """``CommDebugMode``'s counts by the recorder's kinds."""
    out: Dict[str, int] = {}
    for op, n in comm_mode.get_comm_counts().items():
        kind = part_lib.COLLECTIVE_KINDS.get(str(op).split(".")[-1],
                                             str(op))
        out[kind] = out.get(kind, 0) + n
    return out


def _run_partitioned(step: DryStep, device_type: str) -> Dict[str, Any]:
    """Run ``step`` once on DTensors over its mesh (a world of the mesh's
    size must be up) under the FLOP counter, ``CommDebugMode``, the
    collective recorder and the live-bytes tracker."""
    from torch.distributed.tensor.debug import CommDebugMode
    dmesh = mesh_lib.device_mesh(step.mesh, device_type)
    args = tuple(part_lib.distribute(a, s, step.mesh, dmesh)
                 for a, s in zip(step.args, step.arg_specs))
    arg_bytes = part_lib.local_bytes([a for a, s in zip(args, step.arg_specs)
                                      if s is not None])
    rec = part_lib.CollectiveRecorder(dmesh)
    with CommDebugMode() as comm_mode, rec, \
            part_lib.LiveBytes() as live, flops_lib.FlopCounter() as counter:
        out = step.fn(*args)
    counts = _debug_counts(comm_mode)
    if counts != rec.by_kind()[0]:
        raise RuntimeError(f"CommDebugMode counted {counts}, the recorder "
                           f"{rec.counts}")
    return dict(out=out, counted=counter.result(), rec=rec,
                comm_debug_counts=counts, temp_bytes=live.peak,
                argument_bytes=arg_bytes,
                output_bytes=part_lib.local_bytes(step.out_specs(out)[0]))


def _axis_collectives(rec, dims) -> Dict[str, Any]:
    counts, nbytes = rec.by_kind(dims)
    return dict(axes=list(dims), counts=counts, bytes=nbytes,
                total_bytes=float(sum(nbytes.values())))


def analyse(step: DryStep, meta: Dict[str, Any], n_chips: int,
            profile=None, device_type: str = "cpu") -> Dict[str, Any]:
    """Run ``step`` once and report what the reference's ``analyse``
    reports, under its keys (see the module docstring for what differs).
    Unpartitioned, on its meta arguments at the global shape under the
    FLOP counter; partitioned (``step.partitioned``), on DTensors over
    the step's ``DeviceMesh`` (a world of ``n_chips`` ranks must be up;
    ``device_type`` is the mesh's)."""
    if step.partitioned:
        run = _run_partitioned(step, device_type)
        out, counted, rec = run["out"], run["counted"], run["rec"]
        flops_dev = counted["flops"]
        hbm_bytes = counted["bytes"] * 2.0              # read + write
        coll_counts, coll = rec.by_kind()
        coll_total = float(sum(coll.values()))
    else:
        with flops_lib.FlopCounter() as counter:
            out = step.fn(*step.args)
        counted = counter.result()
        flops_dev = counted["flops"] / n_chips
        hbm_bytes = counted["bytes"] * 2.0 / n_chips    # read + write
        coll = {}
        coll_total = 0.0
    if step.plan is not None:
        coll["data_parallel_exchange"] = float(
            step.plan.wire_bytes(step.dp_workers))
        if not step.partitioned:
            coll_total = coll["data_parallel_exchange"]
    terms = dict(compute_s=None, memory_s=None, collective_s=None,
                 dominant=None)
    if profile is not None:
        from repro_torch.tuning.cost import roofline_terms
        from repro_torch.tuning.profile import get_profile
        terms = roofline_terms(flops_dev, hbm_bytes, coll_total, profile)
        meta = dict(meta, roofline_profile=get_profile(profile).name)
    result = dict(meta)
    if step.partitioned:
        dp = [a for a in step.mesh.axis_names if a != "model"]
        result.update(
            flops_global_jaxpr=counted["flops"] * n_chips,
            product_flops_global=counted["product_flops"] * n_chips,
            collective_counts=coll_counts,
            comm_debug_counts=run["comm_debug_counts"],
            model_axis_collectives=_axis_collectives(rec, ["model"]),
            data_axis_collectives=_axis_collectives(rec, dp),
            memory=dict(argument_bytes=run["argument_bytes"],
                        output_bytes=run["output_bytes"],
                        temp_bytes=run["temp_bytes"],
                        generated_code_bytes=None))
    else:
        outs, out_specs = step.out_specs(out)
        result.update(
            flops_global_jaxpr=counted["flops"],
            product_flops_global=counted["product_flops"],
            model_axis_collectives=None,
            memory=dict(
                argument_bytes=sum(shard_lib.shard_bytes(a, s, step.mesh)
                                   for a, s in zip(step.args,
                                                   step.arg_specs)
                                   if s is not None),
                output_bytes=shard_lib.shard_bytes(outs, out_specs,
                                                   step.mesh),
                temp_bytes=None, generated_code_bytes=None))
    result.update(flops_per_device=flops_dev,
                  hbm_bytes_per_device=hbm_bytes,
                  collective_bytes_per_device=coll,
                  collective_total_bytes=coll_total, **terms,
                  n_chips=n_chips)
    return result


def check_mesh(step: DryStep, device_type: str) -> int:
    """Build the step's ``DeviceMesh`` over the (fake) world and the
    DTensor placements of every argument leaf; returns the leaves
    sharded over at least one mesh axis."""
    mesh_lib.device_mesh(step.mesh, device_type)
    sharded = 0
    for specs in step.arg_specs:
        if specs is None:
            continue
        for spec in shard_lib.flatten(specs):
            sharded += any(p.is_shard()
                           for p in shard_lib.placements(spec, step.mesh))
    return sharded


def run_dryrun(arch: str, shape_name: str, multi_pod: bool = False,
               device: str = "cuda", profile=None, **kw) -> Dict[str, Any]:
    """``build_step`` and ``analyse`` in a fake world of the mesh's size,
    plus ``model_flops``."""
    step, meta = build_step(arch, shape_name, multi_pod, **kw)
    n_chips = step.mesh.size
    with fake_world(n_chips):
        meta["sharded_leaves"] = check_mesh(step, device)
        result = analyse(step, meta, n_chips, profile=profile,
                         device_type=device)
    result.update(model_flops(arch, shape_name))
    total = result["flops_global_jaxpr"]
    result["useful_flops_ratio"] = (result["model_flops"] / total
                                    if total else None)
    return result


# ---------------------------------------------------------------------------
# The exchange audit
# ---------------------------------------------------------------------------

def audit_exchange_plan(arch: str = "transformer-big", n_workers: int = 8,
                        reduced: bool = True,
                        sparse_as_dense: bool = True,
                        algorithm: str = "tf_algorithm1",
                        fusion_threshold: Optional[int] = None,
                        reduce_scatter: bool = False,
                        wire_dtype: Optional[str] = None,
                        codec: str = "identity",
                        backend: str = "flat",
                        overlap=False,
                        error_feedback: bool = False,
                        zero1: bool = False,
                        param_codec: str = "identity",
                        batch_per_worker: int = 2,
                        seq_len: int = 32,
                        profile: str = "ib",
                        trace_dir: Optional[str] = None,
                        device: str = "cuda") -> Dict[str, Any]:
    """Check the static ExchangePlan against what the exchange runs.

    Runs the plan-scheduled exchange of the reduced (or full) config's
    real gradient tree (seed-0 parameters, the pipeline's first batch)
    as rank 0 of a fake world of ``n_workers``, with the comm layer's
    call counters reset and a WireRecorder installed, and compares the
    plan's ``hlo_collectives`` / ``wire_bytes`` with what they counted.
    Which exchange runs follows the config, as in the reference: the
    fused ZeRO-1 step under ``zero1``, the wait-free gradient step under
    ``overlap="backward"``, the exchange with its ExchangeState for a
    stateful codec, else the exchange; ``backend="hierarchical"`` runs
    over (2, n_workers // 2) pod groups.  The staged schedule must sum to
    the fused plan's collectives.  The exchange densifies through
    ``kernels.ops.densify`` (``use_kernel=True``, the launcher's
    setting), which drops the ids a fake collective leaves unwritten."""
    from repro_torch.launch.train import pod_groups, resolve_device
    from repro_torch.launch.tune import audit_grads
    from repro_torch.telemetry import trace as trace_lib
    from repro_torch.tuning import cost as tuning_cost
    from repro_torch.tuning.profile import get_profile

    dev = resolve_device(device)
    cfg, grads, model, params, batch = audit_grads(
        arch, reduced, batch_per_worker, seq_len, dev)
    hier = backend == "hierarchical"
    if hier and n_workers % 2:
        raise ValueError("hierarchical audit needs even n_workers")
    workers = (2, n_workers // 2) if hier else n_workers
    with fake_world(n_workers):
        if dist.get_world_size() != n_workers:
            raise RuntimeError(f"the audit needs a world of {n_workers} "
                               f"ranks, the world has "
                               f"{dist.get_world_size()}")
        group = pod_groups(0, n_workers) if hier else dist.group.WORLD
        opt = DistributedOptimizer(
            adamw(noam_schedule(cfg.d_model)),
            exchange=ExchangeConfig(
                sparse_as_dense=sparse_as_dense, algorithm=algorithm,
                fusion_threshold=fusion_threshold,
                reduce_scatter=reduce_scatter, wire_dtype=wire_dtype,
                codec=codec, backend=backend, overlap=overlap,
                error_feedback=error_feedback, zero1=zero1,
                param_codec=param_codec, use_kernel=True),
            group=group)
        plan = opt.plan(grads)
        fn, args = _audit_fn(opt, plan, model, grads, params, batch)
        comm.reset_calls()
        rec = trace_lib.measure_wire(fn, *args)
        calls = {k: v for k, v in comm.calls().items() if v}
        trace_info: Dict[str, Any] = {}
        if trace_dir:
            from repro_torch.telemetry import report as report_lib
            os.makedirs(trace_dir, exist_ok=True)
            out_path = os.path.join(trace_dir, "trace.json")
            trace = trace_lib.capture_exchange_trace(
                plan, fn, args, workers, profile=profile,
                out_path=out_path,
                extra_meta={"arch": arch, "source": "dryrun"})
            rows = report_lib.predicted_vs_measured(trace)
            trace_info = dict(
                trace_path=out_path,
                runtime_wire_exact=report_lib.wire_exact(rows),
                trace_table=report_lib.render_table(rows))
        strategy = opt.exchange_stats(grads, workers, profile=None).strategy

    hlo_ops = sum(calls.values())
    expected_hlo_ops = plan.hlo_collectives(workers)
    planned_wire = plan.wire_bytes(workers)
    recorded_wire = rec.total_wire_bytes()
    recorded_stage = rec.stage_wire_bytes()
    planned_stage = {n: plan.stage_wire_bytes(s, workers) for n, s in
                     zip(plan.stage_names(), plan.schedule.stages)}
    # the staged schedule must be a pure reordering of the fused plan;
    # overlap="backward" re-buckets, so it must cover its own plan
    fused_plan = exchange.compile_plan(
        grads, dataclasses.replace(plan.config, overlap=False))
    stage_coll = [plan.stage_collectives(s) for s in plan.schedule.stages]
    ref_n_collectives = (plan.n_collectives if plan.config.overlap_backward
                         else fused_plan.n_collectives)
    schedule_info = dict(
        n_stages=plan.schedule.n_stages,
        overlap=plan.config.overlap,
        stage_collectives=stage_coll,
        stage_hlo_ops=[plan.stage_hlo_collectives(s, workers)
                       for s in plan.schedule.stages],
        stage_collectives_sum=sum(stage_coll),
        fused_n_collectives=fused_plan.n_collectives,
        stage_sum_matches_fused=(sum(stage_coll) == ref_n_collectives))
    return dict(
        note=None,
        arch=arch, reduced=reduced, n_workers=n_workers,
        audit_mode="fake_pg",
        codec=plan.config.codec, backend=plan.config.backend,
        overlap=plan.config.overlap,
        stateful=plan.config.codec_obj.stateful,
        strategy=strategy,
        planned_n_collectives=plan.n_collectives,
        planned_hlo_ops=expected_hlo_ops,
        hlo_ops=hlo_ops,
        hlo_counts=calls,
        recorded_collectives=rec.total_collectives(),
        counts_match=(hlo_ops == expected_hlo_ops
                      and schedule_info["stage_sum_matches_fused"]),
        planned_wire_bytes=planned_wire,
        planned_hop_wire_bytes=list(plan.hop_wire_bytes(workers)),
        codec_state_bytes=plan.state_bytes(),
        hlo_wire_bytes=recorded_wire,
        wire_ratio=(planned_wire / recorded_wire if recorded_wire
                    else None),
        stage_wire_exact=all(recorded_stage.get(n, 0.0) == b
                             for n, b in planned_stage.items()),
        predicted_comm_us=tuning_cost.predict_comm_us(plan, workers,
                                                      profile),
        cost_profile=get_profile(profile).name,
        schedule=schedule_info,
        schedule_table=plan.describe_schedule(workers),
        plan_table=plan.describe(),
        **trace_info,
    )


def _audit_fn(opt, plan, model, grads, params, batch):
    """The exchange the audit runs and its arguments (see
    ``audit_exchange_plan``)."""
    stateful = plan.config.codec_obj.stateful
    state0 = opt.init_exchange_state(grads) if stateful else None
    if plan.config.zero1:
        z0 = opt.init_zero1_state(grads, params)
        return (lambda g, p, z, s: opt.zero1_step(g, p, z,
                                                  exchange_state=s),
                (grads, params, z0, state0))
    if plan.config.overlap_backward:
        from repro_torch.training.gradients import wait_free_grad_exchange
        return (lambda p, b, s: wait_free_grad_exchange(
                    model, opt, p, b, state=s, sparse_embedding=True),
                (params, batch, state0))
    if stateful:
        return (lambda g, s: opt.exchange(g, state=s), (grads, state0))
    return (lambda g: opt.exchange(g), (grads,))


def audit_exchange_gspmd(arch: str = "transformer-big", n_workers: int = 8,
                         reduced: bool = True,
                         fusion_threshold: Optional[int] = None,
                         codec: str = "identity",
                         backend: str = "flat",
                         batch_per_worker: int = 2,
                         seq_len: int = 32,
                         profile: str = "ib",
                         device: str = "cuda") -> Dict[str, Any]:
    """Planned vs DTensor-chosen collectives for the data-parallel
    reduction (the reference's GSPMD audit, ``audit_mode: "dtensor"``).

    Each worker's contribution tree (the reduced or full config's real
    one) is stacked on a leading axis sharded ``Shard(0)`` over a 1-D
    ``("data",)`` mesh in a fake world of ``n_workers``: each rank holds
    its own slice.  Each rank accumulates its slice by the plan
    (``plan.accumulate_tree`` through ``local_map``), the mean over
    workers is taken and redistributed to ``Replicate()``, and the
    collectives DTensor dispatched for that are reported beside the
    plan's schedule under the reference's keys; ``hlo_wire_bytes`` are
    the dispatched collectives' exact bytes (each call's result), where
    ``planned_wire_bytes`` count what a ring moves (an all-reduce of n
    bytes: 2 (P - 1) / P x n), so the identity wire's ``wire_ratio`` is
    2 (P - 1) / P.  Dense-destined plans only, as in the reference."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.core.indexed_slices import IndexedSlices
    from repro_torch.launch.train import resolve_device
    from repro_torch.launch.tune import audit_grads
    from repro_torch.tuning import cost as tuning_cost
    from repro_torch.tuning.profile import get_profile

    dev = resolve_device(device)
    cfg, grads, _, _, _ = audit_grads(arch, reduced, batch_per_worker,
                                      seq_len, dev)
    opt = DistributedOptimizer(
        adamw(noam_schedule(cfg.d_model)),
        exchange=ExchangeConfig(sparse_as_dense=True,
                                fusion_threshold=fusion_threshold,
                                codec=codec, backend=backend))
    plan = opt.plan(grads)
    if plan.gather_leaf_ids:
        raise ValueError("the partitioned audit supports dense-destined "
                         "plans only (use the fake_pg audit for gather "
                         "plans)")
    leaves, treedef = tree_flatten(grads)

    def tensors(c):             # a contribution's tensors, in order
        if isinstance(c, list):
            return [t for x in c for t in tensors(x)]
        if isinstance(c, IndexedSlices):
            return [c.indices, c.values]
        return [c]

    def rebuild(c, it):         # the contribution from those tensors
        if isinstance(c, list):
            return [rebuild(x, it) for x in c]
        if isinstance(c, IndexedSlices):
            return IndexedSlices(next(it), next(it), c.dense_shape)
        return next(it)
    parts = [t for leaf in leaves for t in tensors(leaf)]
    p = n_workers

    def accumulate(*local):
        it = iter(x[0] for x in local)
        tree = tree_unflatten(treedef, [rebuild(c, it) for c in leaves])
        return tuple(x[None] for x in
                     tree_flatten(plan.accumulate_tree(tree))[0])

    with fake_world(n_workers):
        dmesh = init_device_mesh(dev.type, (n_workers,),
                                 mesh_dim_names=("data",))
        shard = [Shard(0)]
        stacked = [DTensor.from_local(
            t[None], dmesh, shard, run_check=False,
            shape=torch.Size((p,) + tuple(t.shape)),
            stride=torch.empty((p,) + tuple(t.shape),
                               device="meta").stride()) for t in parts]
        rec = part_lib.CollectiveRecorder(dmesh)
        with CommDebugMode() as comm_mode, rec:
            acc = local_map(accumulate,
                            out_placements=tuple([Shard(0)] for _ in
                                                 range(plan.n_leaves)),
                            in_placements=tuple(shard for _ in parts),
                            device_mesh=dmesh)(*stacked)
            for a in acc:
                a.mean(dim=0).redistribute(dmesh, [Replicate()])
        debug_counts = _debug_counts(comm_mode)
        strategy = opt.exchange_stats(grads, p).strategy
    counts, nbytes = rec.by_kind()
    hlo_ops = sum(counts.values())
    planned_ops = plan.hlo_collectives(p)
    planned_wire = plan.wire_bytes(p)
    hlo_wire = float(sum(nbytes.values()))
    return dict(
        arch=arch, reduced=reduced, n_workers=p, audit_mode="dtensor",
        codec=plan.config.codec, backend=plan.config.backend,
        strategy=strategy,
        planned_n_collectives=plan.n_collectives,
        planned_hlo_ops=planned_ops,
        hlo_ops=hlo_ops,
        hlo_counts=counts,
        hlo_bytes=nbytes,
        comm_debug_counts=debug_counts,
        counts_match=hlo_ops == planned_ops,
        collectives_found=hlo_ops > 0,
        collective_delta=hlo_ops - planned_ops,
        planned_wire_bytes=planned_wire,
        hlo_wire_bytes=hlo_wire,
        wire_ratio=(planned_wire / hlo_wire if hlo_wire else None),
        predicted_comm_us=tuning_cost.predict_comm_us(plan, p, profile),
        cost_profile=get_profile(profile).name,
        plan_table=plan.describe(),
    )


# ---------------------------------------------------------------------------
# Reference FLOPs from the config
# ---------------------------------------------------------------------------

def model_flops(arch: str, shape_name) -> Dict[str, float]:
    """6*N*D (dense) / 6*N_active*D (MoE) reference FLOPs (``shape_name``
    an ``INPUT_SHAPES`` name or an ``InputShape``)."""
    cfg = get_config(arch)
    shape = _input_shape(shape_name)
    n_params, n_active = param_counts(cfg)
    d_tokens = shape.global_batch * (shape.seq_len if shape.kind == "train"
                                     else 1)
    if shape.kind == "prefill":
        d_tokens = shape.global_batch * shape.seq_len
    mult = 6.0 if shape.kind == "train" else 2.0
    return {"n_params": n_params, "n_active": n_active,
            "model_flops": mult * n_active * d_tokens}


def param_counts(cfg) -> tuple:
    """(total params, activated params) from the config arithmetic."""
    d, v = cfg.d_model, cfg.vocab
    emb = v * d * (1 if cfg.tied_embeddings else 2)
    hd = cfg.resolved_head_dim
    per_layer_attn = d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd \
        + cfg.n_heads * hd * d
    if cfg.mla is not None:
        m = cfg.mla
        per_layer_attn = (d * cfg.n_heads * (m.nope_dim + m.rope_dim)
                          + d * m.kv_lora + d * m.rope_dim
                          + m.kv_lora * cfg.n_heads * (m.nope_dim + m.v_dim)
                          + cfg.n_heads * m.v_dim * d)
    if cfg.family == "ssm":
        x = cfg.xlstm
        di = x.mlstm_expand * d
        per_layer = (d * 2 * di + 3 * di * di + di * d      # mlstm
                     + 4 * d * d + int(d * x.slstm_ff_mult) * 2 * d)
        total = emb + cfg.n_layers * per_layer
        return float(total), float(total)
    if cfg.family == "hybrid":
        s = cfg.ssm
        di = s.expand * d
        h = di // s.head_dim
        per_mamba = d * (2 * di + 2 * s.state_dim + h) + di * d
        shared = per_layer_attn + 3 * d * cfg.d_ff
        total = emb + cfg.n_layers * per_mamba + shared
        return float(total), float(total)
    if cfg.moe is not None:
        mo = cfg.moe
        expert = 3 * d * mo.d_ff_expert
        shared = mo.n_shared * expert
        per_layer_total = per_layer_attn + mo.n_experts * expert + shared \
            + d * mo.n_experts
        per_layer_active = per_layer_attn + mo.top_k * expert + shared \
            + d * mo.n_experts
        return (float(emb + cfg.n_layers * per_layer_total),
                float(emb + cfg.n_layers * per_layer_active))
    per_layer = per_layer_attn + 3 * d * cfg.d_ff
    if cfg.frontend is not None and cfg.frontend.cross_attention:
        per_layer += 4 * d * cfg.n_heads * hd
    total = emb + cfg.n_layers * per_layer
    return float(total), float(total)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

NO_HLO = ("--print-hlo prints XLA's HLO; the port compiles nothing (its "
          "steps run eagerly, on meta tensors or on DTensors over the mesh)")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None, choices=list(ARCH_IDS))
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--audit-exchange", action="store_true",
                    help="audit the static ExchangePlan against the "
                         "collectives the exchange runs in a fake world "
                         "instead of running a dry run")
    ap.add_argument("--audit-workers", type=int, default=8)
    ap.add_argument("--audit-mode", default="shard_map",
                    choices=["shard_map", "gspmd"],
                    help="shard_map: the plan-scheduled collectives must "
                         "match the plan exactly; gspmd: report the "
                         "collectives DTensor dispatches for the "
                         "data-parallel reduction beside the plan")
    ap.add_argument("--codec", default="identity",
                    help="WireCodec registry name (registered: "
                         f"{', '.join(available_codecs())}; append "
                         "'+ef' for error feedback)")
    ap.add_argument("--backend", default="flat",
                    help="CollectiveBackend registry name (registered: "
                         f"{', '.join(available_backends())})")
    ap.add_argument("--error-feedback", action="store_true")
    ap.add_argument("--overlap", nargs="?", const="staged", default=None,
                    choices=["staged", "backward"])
    ap.add_argument("--full-size", action="store_true",
                    help="with --audit-exchange or --tune: the full (not "
                         "reduced) config")
    ap.add_argument("--tune", action="store_true",
                    help="search the ExchangeConfig space "
                         "(repro_torch.launch.tune) and cache the winner")
    ap.add_argument("--trials", type=int, default=0)
    ap.add_argument("--top-k", type=int, default=5)
    ap.add_argument("--profile", default=None,
                    help="BandwidthProfile preset name or JSON path: the "
                         "dry run's roofline terms (none without it); the "
                         "audit's and --tune's cost model (default "
                         "ethernet)")
    ap.add_argument("--tune-cache", default=None,
                    help="tuning artifact directory (default: "
                         "experiments/tuning_torch)")
    ap.add_argument("--grad-accum", default="dense_reduce",
                    choices=["sparse_gather", "dense_reduce"])
    ap.add_argument("--fusion-threshold", type=int, default=None)
    ap.add_argument("--reduce-scatter", action="store_true")
    ap.add_argument("--wire-dtype", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mode", default="meta", choices=sorted(MODES),
                    help="meta: the step unpartitioned on meta tensors; "
                         "gspmd: partitioned, on DTensors over the mesh, "
                         "with the model-axis collectives and temp bytes")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--zero1", action="store_true")
    ap.add_argument("--param-codec", default="identity")
    ap.add_argument("--pure-dp", action="store_true",
                    help="paper-faithful Horovod layout: replicated "
                         "weights, batch over all axes, grads allreduced")
    ap.add_argument("--attn-impl", default="chunked")
    ap.add_argument("--ssm-chunk", type=int, default=None)
    ap.add_argument("--moe-decode", default="dropless",
                    choices=["dropless", "capacity"])
    ap.add_argument("--loss-chunk", type=int, default=512)
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="with --audit-exchange: also write a Chrome "
                         "trace of one instrumented exchange to "
                         "DIR/trace.json")
    ap.add_argument("--sweep", action="store_true",
                    help="dry-run every arch x shape x (1pod, 2pod) into "
                         "experiments/dryrun_torch/")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: the audit's and --tune's "
                         "device, and the DeviceMesh's (the dry run's "
                         "tensors are meta)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--print-hlo", action="store_true")
    return ap.parse_args(argv)


def unshardable_op(exc: BaseException) -> str:
    """The op DTensor found no sharding for, from its error (the
    message's first line where it names none)."""
    import re
    text = str(exc)
    m = re.search(r"(aten\.[\w.]+)", text)
    return m.group(1) if m else text.strip().splitlines()[0][:200]


def _dry(arch, shape, multi_pod, device, profile, kw) -> Dict[str, Any]:
    """``run_dryrun``; a partitioned step that DTensor cannot lay out
    gives ``{"error": ..., "op": ...}`` naming the op."""
    try:
        return run_dryrun(arch, shape, multi_pod, device, profile, **kw)
    except (RuntimeError, NotImplementedError) as exc:
        if MODES[kw.get("mode", "meta")] != "dtensor":
            raise
        return dict(arch=arch, shape=shape, mode="dtensor",
                    error=f"the partitioned step has no sharding for "
                          f"{unshardable_op(exc)}",
                    op=unshardable_op(exc))


def _write(result: Dict[str, Any], path: Optional[str]) -> None:
    if path:
        with open(path, "w") as f:
            json.dump(result, f, indent=2, default=str)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.print_hlo:
        print(f"not ported: {NO_HLO}", file=sys.stderr)
        return 2
    if args.tune:
        from repro_torch.launch import tune
        tune_argv = ["--arch", args.arch or "transformer-big",
                     "--audit-workers", str(args.audit_workers),
                     "--profile", args.profile or "ethernet",
                     "--trials", str(args.trials), "--top-k",
                     str(args.top_k), "--device", args.device]
        if args.full_size:
            tune_argv.append("--full-size")
        if args.tune_cache:
            tune_argv += ["--tune-cache", args.tune_cache]
        if args.out:
            tune_argv += ["--out", args.out]
        return tune.main(tune_argv)
    if args.audit_exchange and args.audit_mode == "gspmd":
        result = audit_exchange_gspmd(
            arch=args.arch or "transformer-big",
            n_workers=args.audit_workers, reduced=not args.full_size,
            fusion_threshold=args.fusion_threshold, codec=args.codec,
            backend=args.backend, profile=args.profile or "ethernet",
            device=args.device)
        print(json.dumps(result, indent=2, default=str))
        _write(result, args.out)
        # a comparison: DTensor may legally fuse or split the reduction
        return 0 if result["collectives_found"] else 1
    if args.audit_exchange:
        result = audit_exchange_plan(
            arch=args.arch or "transformer-big",
            n_workers=args.audit_workers, reduced=not args.full_size,
            sparse_as_dense=args.grad_accum == "dense_reduce",
            fusion_threshold=args.fusion_threshold,
            reduce_scatter=args.reduce_scatter, wire_dtype=args.wire_dtype,
            codec=args.codec, backend=args.backend,
            overlap=args.overlap or False,
            error_feedback=args.error_feedback, zero1=args.zero1,
            param_codec=args.param_codec,
            profile=args.profile or "ethernet", trace_dir=args.trace,
            device=args.device)
        table = result.pop("trace_table", None)
        print(json.dumps(result, indent=2, default=str))
        if table:
            print("\npredicted vs measured (runtime trace):")
            print(table)
        _write(result, args.out)
        return 0 if result["counts_match"] else 1
    kw = dict(fsdp=not args.no_fsdp, pure_dp=args.pure_dp, zero1=args.zero1,
              attn_impl=args.attn_impl, ssm_chunk=args.ssm_chunk,
              moe_decode=args.moe_decode, loss_chunk=args.loss_chunk,
              mode=args.mode)
    if args.sweep:
        os.makedirs(SWEEP_DIR, exist_ok=True)
        failed = 0
        for arch in ARCH_IDS:
            for shape in INPUT_SHAPES:
                for pod, multi in (("1pod", False), ("2pod", True)):
                    result = _dry(arch, shape, multi, args.device,
                                  args.profile, kw)
                    tag = "" if MODES[args.mode] == "meta" else "__dtensor"
                    path = os.path.join(
                        SWEEP_DIR, f"{arch}__{shape}__{pod}{tag}.json")
                    _write(result, path)
                    if "error" in result:
                        failed += 1
                        print(f"{path}: {result['error']}")
                    else:
                        print(f"{path}: {result['flops_global_jaxpr']:.4g} "
                              f"flop")
        return 1 if failed else 0
    if args.arch is None or args.shape is None:
        print("--arch and --shape are required unless --audit-exchange, "
              "--tune or --sweep is given", file=sys.stderr)
        return 2
    result = _dry(args.arch, args.shape, args.multi_pod, args.device,
                  args.profile, kw)
    if "error" in result:
        print(f"{args.arch} {args.shape}: {result['error']}",
              file=sys.stderr)
        _write(result, args.out)
        return 1
    result.update(fsdp=not args.no_fsdp, ssm_chunk=args.ssm_chunk,
                  moe_decode=args.moe_decode, loss_chunk=args.loss_chunk)
    print(json.dumps(result, indent=2, default=str))
    _write(result, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
