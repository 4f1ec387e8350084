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

The gradient wire is ``--codec {identity,bf16,f16,int8}``;
``--error-feedback`` makes it ``<codec>+ef`` (a per-bucket f32 residual
threaded from step to step).  The densify and quantize kernels are always
on the exchange path (``ExchangeConfig(use_kernel=True)``).  Runs on the
card unless ``--device cpu`` is given.

Example (4 cards):
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \
    --arch transformer-big --dist horovod --grad-accum dense_reduce \
    --codec int8 --error-feedback
"""
from __future__ import annotations

import argparse
import os
import socket
import sys
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core import (DistributedOptimizer, ExchangeConfig,
                              available_codecs)
from repro_torch.data import make_pipeline
from repro_torch.models import build_model
from repro_torch.optim import adamw, noam_schedule
from repro_torch.training import (Trainer, TrainerConfig,
                                  grad_contributions, make_train_step)


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
    ap.add_argument("--codec", default="identity",
                    help="WireCodec registry name for the gradient wire "
                         f"(registered: {', '.join(available_codecs())}; "
                         "append '+ef' to any name, or pass "
                         "--error-feedback, for error feedback)")
    ap.add_argument("--error-feedback", action="store_true",
                    help="wrap the codec in ErrorFeedbackCodec: keep a "
                         "per-bucket f32 residual of the wire's "
                         "quantisation error and fold it into the next "
                         "step's encode")
    ap.add_argument("--batch-per-worker", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--warmup", type=int, default=400)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--task", default="lm", choices=["lm", "translation"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
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


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


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
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{_free_port()}",
            rank=0, world_size=1)
    return dist.get_rank(), dist.get_world_size(), True


def build_optimizer(args, cfg, group) -> DistributedOptimizer:
    base = adamw(noam_schedule(cfg.d_model, warmup_steps=args.warmup))
    exchange = ExchangeConfig(
        sparse_as_dense=args.grad_accum == "dense_reduce",
        algorithm=args.algorithm,
        fusion_threshold=args.fusion_threshold,
        codec=args.codec, error_feedback=args.error_feedback,
        use_kernel=True)
    return DistributedOptimizer(base, exchange=exchange, group=group)


def meta_worker_grads(args, model, pipe, sparse_embedding: bool):
    """One worker's gradient-contribution tree on ``meta`` tensors (no
    memory, no compute): the structure the ExchangePlan and its
    ExchangeState are keyed on."""
    meta = torch.device("meta")
    batch = {k: torch.empty((args.batch_per_worker,) + v.shape[1:],
                            dtype=torch.from_numpy(v[:0]).dtype,
                            device=meta)
             for k, v in pipe.batch_at(0).items()}
    grads, _, _ = grad_contributions(model, model.init(device=meta), batch,
                                     sparse_embedding=sparse_embedding)
    return grads


def run(argv=None, log: Optional[Callable[[str], None]] = None
        ) -> Dict[str, Any]:
    """Train as the command line says; returns the Trainer's result
    (``params``, ``opt_state``, ``history``)."""
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
            log(f"horovod mode: {world} workers "
                f"({dist.get_backend(group)}), global batch "
                f"{args.batch_per_worker * world}x{args.seq_len} tokens")
        params = model.init(seed=args.seed, device=device)
        opt = build_optimizer(args, cfg, group)
        step = make_train_step(model, opt, sparse_embedding=sparse_embedding)
        pipe = make_pipeline(cfg, batch_per_host=args.batch_per_worker * world,
                             seq_len=args.seq_len, seed=args.seed,
                             task=args.task)
        ex_state = opt.init_exchange_state(
            meta_worker_grads(args, model, pipe, sparse_embedding),
            device=device)
        trainer = Trainer(model, step, pipe, TrainerConfig(
            total_steps=args.steps, log_every=args.log_every),
            device=device, rank=rank, world=world)
        result = trainer.run(params, opt.init(params), ex_state, log=log)
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
