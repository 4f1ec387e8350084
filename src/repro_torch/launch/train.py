"""Training launcher CLI for the port (``repro.launch.train``).

  * ``--dist local``   — one process, no collectives.
  * ``--dist horovod`` — Horovod-faithful data parallelism over a
    ``torch.distributed`` process group (NCCL on the card, gloo on the
    CPU) with EXPLICIT gradient collectives chosen by the accumulation
    strategy.  Rank and world size come from ``torchrun``'s environment;
    without it the run is a world of 1.

Strategy flags map 1:1 to the paper:
  --grad-accum sparse_gather   TF Algorithm 1 (gather; the pathology)
  --grad-accum dense_reduce    sparse_as_dense=True (the paper's fix)

The gradient wire is ``--codec {identity,bf16,f16,f8e4m3,f8e5m2,int8}``
(``--wire-dtype bf16`` is the deprecated spelling of ``--codec bf16``);
``--error-feedback`` makes it ``<codec>+ef`` (a per-bucket f32 residual
threaded from step to step).  ``--backend {flat,hierarchical,ringsim}``
picks how a bucket crosses the workers: one collective over the world,
one allreduce per level of a 2 x P/2 (pod, data) world (each rank joins
its cross-pod and its within-pod group, ranks pod-major), or the literal
send/recv ring.  ``--reduce-scatter`` exchanges dense buckets as
reduce-scatter + allgather.  ``--overlap staged`` launches every
bucket's collective before any unpacks; ``--overlap backward`` launches
each block's buckets from inside the backward pass (wait-free backprop).
``--zero1`` shards the AdamW state (ZeRO-1): each dense bucket's
gradient is reduce-scattered, each rank updates its 1/P flat shard and
the updated params are allgathered through ``--param-codec`` (a
stateless codec; ``identity`` keeps the step bitwise the replicated
one).  ``--checkpoint-dir D --checkpoint-every N`` saves the training
state every N steps in the reference's file format; ``--resume``
continues from the latest checkpoint in D.  The densify and quantize
kernels are always on the exchange path
(``ExchangeConfig(use_kernel=True)``).  Runs on the card unless
``--device cpu`` is given.

Telemetry: a run with overlap, a stateful codec, ``--zero1`` or the
hierarchical backend logs the plan's schedule and accounting
(``print_exchange_schedule``, costed under ``--profile``);
``--metrics-jsonl F`` streams per-step rows (loss, ``step_ms`` split into
``data_ms`` / ``compute_ms``, tok/s), the windowed history and a summary
to F (rank 0); ``--trace-dir D`` captures one traced step at the final
weights after training (on copies of the state) and writes
``D/trace.json``, a Chrome trace of the exchange's stages that
``scripts/trace_report_torch.py`` summarizes.

Example (4 cards):
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
    --arch transformer-big --dist horovod --grad-accum dense_reduce \
    --codec int8 --error-feedback
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.checkpoint import ShardedCheckpoint
from repro_torch.configs import get_config
from repro_torch.core import (DistributedOptimizer, ExchangeConfig,
                              available_backends, available_codecs)
from repro_torch.data import make_pipeline
from repro_torch.models import build_model
from repro_torch.optim import adamw, noam_schedule
from repro_torch.telemetry.metrics import MetricsLogger, StepRecorder
from repro_torch.training import Trainer, TrainerConfig, make_train_step
from repro_torch.training.gradients import wait_free_contribution_structs


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", default="transformer-big")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized variant of the arch")
    ap.add_argument("--dist", default="local", choices=["local", "horovod"])
    ap.add_argument("--grad-accum", default="dense_reduce",
                    choices=["sparse_gather", "dense_reduce"])
    ap.add_argument("--algorithm", default="tf_algorithm1",
                    choices=["tf_algorithm1", "proposed_algorithm2"])
    ap.add_argument("--fusion-threshold", type=int, default=None)
    ap.add_argument("--reduce-scatter", action="store_true",
                    help="exchange dense buckets via reduce-scatter + "
                         "allgather instead of allreduce")
    ap.add_argument("--wire-dtype", default=None,
                    choices=[None, "bf16", "bfloat16", "f16", "float16"],
                    help="deprecated spelling of --codec: downcast "
                         "fusion buffers to this dtype on the wire")
    ap.add_argument("--codec", default="identity",
                    help="WireCodec registry name for the gradient wire "
                         f"(registered: {', '.join(available_codecs())}; "
                         "append '+ef' to any name, or pass "
                         "--error-feedback, for error feedback)")
    ap.add_argument("--backend", default="flat",
                    help="CollectiveBackend registry name (registered: "
                         f"{', '.join(available_backends())})")
    ap.add_argument("--error-feedback", action="store_true",
                    help="wrap the codec in ErrorFeedbackCodec: keep a "
                         "per-bucket f32 residual of the wire's "
                         "quantisation error and fold it into the next "
                         "step's encode")
    ap.add_argument("--overlap", nargs="?", const="staged", default=None,
                    choices=["staged", "backward"],
                    help="comm/compute overlap mode. 'staged' (also the "
                         "bare flag): launch the bucket collectives in "
                         "reverse-layer order, interleaved with the "
                         "remaining accumulation, before any bucket "
                         "unpacks. 'backward': wait-free backprop, "
                         "buckets block-aligned and each block's "
                         "collectives launched from inside the backward "
                         "pass")
    ap.add_argument("--zero1", action="store_true",
                    help="ZeRO-1: reduce-scatter each dense bucket's "
                         "gradient, run the optimizer on this worker's "
                         "1/P flat shard of the EMA state (and the f32 "
                         "master params under a lossy --param-codec), "
                         "and allgather the UPDATED params back through "
                         "the same bucket schedule")
    ap.add_argument("--param-codec", default="identity",
                    help="WireCodec of the zero1 updated-param allgather "
                         "(stateless codecs only; the default identity "
                         "keeps the step bitwise the replicated one)")
    ap.add_argument("--batch-per-worker", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--warmup", type=int, default=400)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--task", default="lm", choices=["lm", "translation"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--profile", default="ethernet",
                    help="BandwidthProfile preset name or JSON path (the "
                         "cost model's predicted_comm_us estimates)")
    ap.add_argument("--metrics-jsonl", default=None,
                    help="stream per-step metrics (loss, step_ms split "
                         "into data_ms/compute_ms, tok/s, overflow-"
                         "skipped steps) and the run history to this "
                         "JSONL file")
    ap.add_argument("--trace-dir", default=None,
                    help="after training, capture one traced step (a "
                         "phase tap at every exchange stage boundary and "
                         "the runtime wire-byte counters) and write a "
                         "Chrome-trace JSON here; summarize with "
                         "scripts/trace_report_torch.py")
    return ap.parse_args(argv)


def resolve_device(name: str) -> torch.device:
    """``cuda`` needs a card (raises otherwise); under torchrun each rank
    takes the card of its ``LOCAL_RANK``."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device is available "
                               "(pass --device cpu to run on the CPU)")
        if device.index is None:
            device = torch.device("cuda",
                                  int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    elif device.type != "cpu":
        raise ValueError(f"--device must be cuda or cpu, got {name!r}")
    return device


def init_distributed(device: torch.device) -> Tuple[int, int, bool]:
    """Join (or start) the data-parallel process group.  Returns ``(rank,
    world, created)``; ``created`` says this call started the group and
    the caller must destroy it."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), False
    backend = "nccl" if device.type == "cuda" else "gloo"
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        # a world of 1 on a store whose port the kernel picks as it binds
        # it: a port found free and then bound can be taken in between
        store = dist.TCPStore("localhost", 0, world_size=1, is_master=True)
        dist.init_process_group(backend, store=store, rank=0, world_size=1)
    return dist.get_rank(), dist.get_world_size(), True


def build_optimizer(args, cfg, group) -> DistributedOptimizer:
    base = adamw(noam_schedule(cfg.d_model, warmup_steps=args.warmup))
    exchange = ExchangeConfig(
        sparse_as_dense=args.grad_accum == "dense_reduce",
        algorithm=args.algorithm,
        fusion_threshold=args.fusion_threshold,
        reduce_scatter=args.reduce_scatter, wire_dtype=args.wire_dtype,
        codec=args.codec, backend=args.backend,
        error_feedback=args.error_feedback,
        overlap=args.overlap or False, zero1=args.zero1,
        param_codec=args.param_codec, use_kernel=True)
    return DistributedOptimizer(base, exchange=exchange, group=group)


def pod_groups(rank: int, world: int):
    """``(cross_pod_group, within_pod_group)`` of ``rank`` in a world laid
    out as 2 pods of ``world // 2`` ranks, pod-major (the reference's
    ``Mesh(devices.reshape(2, n // 2), ("pod", "data"))``).  Every rank
    creates every group, in the same order, as ``new_group`` requires."""
    if world % 2:
        raise SystemExit("hierarchical backend needs an even worker count "
                         "(2 emulated pods)")
    half = world // 2
    within = [dist.new_group(list(range(p * half, (p + 1) * half)))
              for p in range(2)]
    cross = [dist.new_group([d, half + d]) for d in range(half)]
    return cross[rank % half], within[rank // half]


def exchange_workers(args, opt, world: int):
    """The worker count the plan's accounting is priced at: 1 for
    ``--dist local``, ``(2, world // 2)`` on the hierarchical backend,
    else the world."""
    if args.dist != "horovod":
        return 1
    if opt.exchange_config.backend == "hierarchical":
        return (2, world // 2)
    return world


def print_exchange_schedule(args, opt, grads, world: int,
                            log: Callable[[str], None] = print) -> None:
    """Log the plan's BucketSchedule: what the step will actually run,
    stage by stage, with codec-state (residual) memory, the per-hop wire
    split on hierarchical runs and the cost model's prediction under
    ``--profile``.  Informational: a failure is logged, not raised."""
    try:
        log(opt.exchange_stats(grads, n_workers=exchange_workers(
            args, opt, world), profile=args.profile).describe())
    except Exception as e:                       # informational only
        log(f"(exchange schedule unavailable: {e})")


def capture_training_trace(args, opt, grads, step_fn, trainer, result,
                           world: int,
                           log: Callable[[str], None] = print) -> dict:
    """``--trace-dir``: capture one traced step at the final state and
    write ``trace.json`` there (rank 0), then log the predicted-vs-
    measured table.  The training loop itself ran untraced; the capture
    runs on copies of the final state (``StepTracer.capture``), so the
    returned training state is the loop's.  Every rank must call it.
    Returns the trace."""
    from repro_torch.telemetry import report as report_lib
    from repro_torch.telemetry import trace as trace_lib
    fn_args = (result["params"], result["opt_state"],
               result["exchange_state"], trainer.batch_at(0))
    os.makedirs(args.trace_dir, exist_ok=True)
    out_path = os.path.join(args.trace_dir, "trace.json")
    trace = trace_lib.capture_exchange_trace(
        opt.plan(grads), step_fn, fn_args, exchange_workers(args, opt, world),
        profile=args.profile, out_path=out_path,
        extra_meta={"arch": args.arch, "dist": args.dist,
                    "steps": args.steps})
    log(f"trace written: {out_path}")
    log(report_lib.render_table(report_lib.predicted_vs_measured(trace)))
    return trace


def meta_worker_grads(args, model, pipe, sparse_embedding: bool):
    """One worker's gradient-contribution tree on ``meta`` tensors (no
    memory, no compute): the structure the ExchangePlan and its
    ExchangeState are keyed on, the one ``grad_contributions`` returns,
    built from the parameters' shapes and the batch's token count
    without a forward or backward pass (on meta tensors those still cost
    the host every eager operation of a step, a recurrence's included)."""
    meta = torch.device("meta")
    batch = {k: torch.empty((args.batch_per_worker,) + v.shape[1:],
                            dtype=torch.from_numpy(v[:0]).dtype,
                            device=meta)
             for k, v in pipe.batch_at(0).items()}
    return wait_free_contribution_structs(
        model, model.init(device=meta), batch,
        sparse_embedding=sparse_embedding)


def run(argv=None, log: Optional[Callable[[str], None]] = None
        ) -> Dict[str, Any]:
    """Train as the command line says; returns the Trainer's result
    (``params``, ``opt_state``, ``exchange_state``, ``history``).  Under
    ``--zero1`` ``opt_state`` is this rank's ``Zero1State``."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    # the instrumented sparse path is the whole point in horovod mode
    sparse_embedding = args.dist == "horovod" or \
        args.grad_accum == "sparse_gather"
    rank, world, created = 0, 1, False
    group = None
    if args.dist == "horovod":
        rank, world, created = init_distributed(device)
        group = dist.group.WORLD
    if log is None:
        log = print if rank == 0 else (lambda s: None)
    try:
        if args.dist == "horovod":
            shape = ""
            if args.backend == "hierarchical":
                group = pod_groups(rank, world)
                shape = f"2x{world // 2} pod/data, "
            log(f"horovod mode: {world} workers ({shape}"
                f"{dist.get_backend()}), global batch "
                f"{args.batch_per_worker * world}x{args.seq_len} tokens")
        params = model.init(seed=args.seed, device=device)
        opt = build_optimizer(args, cfg, group)
        step = make_train_step(model, opt, sparse_embedding=sparse_embedding)
        pipe = make_pipeline(cfg, batch_per_host=args.batch_per_worker * world,
                             seq_len=args.seq_len, seed=args.seed,
                             task=args.task)
        meta = meta_worker_grads(args, model, pipe, sparse_embedding)
        ex_state = opt.init_exchange_state(meta, device=device)
        ex_cfg = opt.exchange_config
        if ex_cfg.overlap or ex_cfg.codec_obj.stateful or ex_cfg.zero1 \
                or ex_cfg.backend == "hierarchical":
            print_exchange_schedule(args, opt, meta, world, log)
        # under zero1 the optimizer state is this rank's slice of the
        # Zero1State, laid out along the plan's bucket partition
        opt_state = (opt.init_zero1_state(meta, params) if opt.zero1
                     else opt.init(params))
        recorder = None
        if args.metrics_jsonl and rank == 0:
            # the global token count the Trainer's tok_per_s uses
            recorder = StepRecorder(
                MetricsLogger(args.metrics_jsonl),
                tokens_per_step=int(pipe.batch_at(0)["tokens"].size))
        trainer = Trainer(model, step, pipe, TrainerConfig(
            total_steps=args.steps, log_every=args.log_every,
            checkpoint_every=args.checkpoint_every,
            checkpoint_dir=args.checkpoint_dir, resume=args.resume),
            device=device, rank=rank, world=world,
            checkpoint=ShardedCheckpoint(
                opt.plan(meta),
                dist.group.WORLD if args.dist == "horovod" else None),
            recorder=recorder)
        result = trainer.run(params, opt_state, ex_state, log=log)
        if recorder is not None:
            for h in result["history"]:
                recorder.logger.emit("history", **h)
            recorder.close()
            log(f"metrics written: {args.metrics_jsonl}")
        if args.trace_dir:
            capture_training_trace(args, opt, meta, step, trainer, result,
                                   world, log)
    finally:
        if created:
            dist.destroy_process_group()
    final = result["history"][-1] if result["history"] else {}
    log(f"done: {final}")
    return result


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
