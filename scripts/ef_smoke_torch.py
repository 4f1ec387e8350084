"""Smoke check on the PyTorch port: the int8 + error-feedback wire must
track the f32 wire.

Trains the reduced transformer-big three times from the same init and
data (f32 wire, int8 wire, int8+ef wire) and checks that the
error-feedback run's loss lands within ``--tolerance`` nats of the f32
run's and no further from it than plain int8's (with 0.05 of slack for
the noise of a tail of 5 early losses).  That is the convergence
contract the stateful codec API exists to deliver.  Every step runs the
densify kernel and, on the int8 wires, the quantize kernels
(``use_kernel=True``).

The workers are the ranks of a ``torch.distributed`` world: gloo on the
CPU, NCCL on the card with one rank a card; without ``torchrun`` it is a
world of 1.  ``--workers``, when given, must equal the world's size.

    PYTHONPATH=src python scripts/ef_smoke_torch.py [--steps 60]
    PYTHONPATH=src torchrun --nproc-per-node 8 scripts/ef_smoke_torch.py \\
        --device cpu --workers 8

Prints the three runs' losses and a PASS or FAIL line, and exits 0 or 1.
``final_loss`` trains one run of any config and returns its history.
"""
import argparse
import sys
from typing import Dict, List, Optional

import numpy as np
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core import DistributedOptimizer, ExchangeConfig
from repro_torch.data import make_pipeline
from repro_torch.launch.train import init_distributed, resolve_device
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.training import Trainer, TrainerConfig, make_train_step
from repro_torch.training.gradients import abstract_grad_contributions
from repro_torch.tree import tree_map

#: slack of the relative check ("ef no further from f32 than raw int8"):
#: tail-of-5 losses this early jitter by a few hundredths
NOISE = 0.05
#: the three wires: (codec, error_feedback)
WIRES = (("identity", False), ("int8", False), ("int8", True))


def exchange_config(codec: str, error_feedback: bool) -> ExchangeConfig:
    """The runs' exchange: the Horovod pre-pass densifies the tied
    embedding, 1 MiB fusion buffers, the kernels on."""
    return ExchangeConfig(sparse_as_dense=True, codec=codec,
                          error_feedback=error_feedback,
                          fusion_threshold=1 << 20, use_kernel=True)


def final_loss(cfg, codec: str, error_feedback: bool, steps: int, device,
               params=None) -> List[Dict[str, float]]:
    """Train ``cfg`` for ``steps`` steps on the initialised world with
    the given wire and return the trainer's history (a row every
    ``max(1, steps // 15)`` steps and at the last).  Each rank takes 2
    rows of 16 tokens of the copy task.  ``params`` (copied, since the
    step updates its arguments in place) replaces the seed-0 init."""
    rank, world = dist.get_rank(), dist.get_world_size()
    model = build_model(cfg)
    params = (model.init(seed=0, device=device) if params is None
              else tree_map(lambda t: t.detach().clone().to(device), params))
    opt = DistributedOptimizer(adamw(1e-2),
                               exchange_config(codec, error_feedback),
                               group=dist.group.WORLD)
    step = make_train_step(model, opt, sparse_embedding=True)
    pipe = make_pipeline(cfg, batch_per_host=2 * world, seq_len=16,
                         task="copy")
    trainer = Trainer(model, step, pipe, TrainerConfig(
        total_steps=steps, log_every=max(1, steps // 15)), device=device,
        rank=rank, world=world)
    g = abstract_grad_contributions(model, params, trainer.batch_at(0),
                                    sparse_embedding=True)
    ex_state = opt.init_exchange_state(g, device=device)
    res = trainer.run(params, opt.init(params), ex_state,
                      log=lambda s: None)
    return res["history"]


def tail_mean(history: List[Dict[str, float]]) -> float:
    """Single-step losses are noisy this early in training: the mean of
    the last 5 logged ones."""
    return float(np.mean([h["loss"] for h in history][-5:]))


def verdict(f32: float, q8: float, ef: float, tolerance: float) -> dict:
    gap, ef_gap = q8 - f32, ef - f32
    return {"f32": f32, "int8": q8, "int8_ef": ef, "gap": gap,
            "ef_gap": ef_gap,
            "ok": abs(ef_gap) <= tolerance and abs(ef_gap) <= abs(gap)
            + NOISE}


def report(v: dict, tolerance: float) -> List[str]:
    """The reference script's three loss lines and its PASS/FAIL line."""
    return [
        f"fp32 wire      final loss: {v['f32']:.4f}",
        f"int8 wire      final loss: {v['int8']:.4f}  "
        f"(gap {v['gap']:+.4f})",
        f"int8+ef wire   final loss: {v['int8_ef']:.4f}  "
        f"(gap {v['ef_gap']:+.4f})",
        f"{'PASS' if v['ok'] else 'FAIL'}: |ef-fp32|={abs(v['ef_gap']):.4f} "
        f"tolerance={tolerance} |int8-fp32|={abs(v['gap']):.4f} "
        f"noise_slack={NOISE}"]


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--workers", type=int, default=None,
                    help="the world's size, checked (default: whatever "
                         "torchrun started; 1 without it)")
    ap.add_argument("--tolerance", type=float, default=0.15,
                    help="max |loss_ef - loss_fp32| in nats")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    rank, world, created = init_distributed(device)
    try:
        if args.workers is not None and args.workers != world:
            raise ValueError(
                f"--workers {args.workers}, but the world has {world} "
                f"rank(s): run under torchrun --nproc-per-node "
                f"{args.workers}")
        cfg = get_config("transformer-big").reduced()
        tails = [tail_mean(final_loss(cfg, codec, ef, args.steps, device))
                 for codec, ef in WIRES]
        # each rank logs its own rows' loss: rank 0's decide, on every rank
        dist.broadcast_object_list(tails, src=0)
    finally:
        if created:
            dist.destroy_process_group()
    v = verdict(*tails, args.tolerance)
    if rank == 0:
        print("\n".join(report(v, args.tolerance)))
    return 0 if v["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
