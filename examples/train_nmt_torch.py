"""End-to-end NMT training on the PyTorch port.

Trains a ~100M-parameter variant of the paper's transformer on the
synthetic translation corpus with the paper's dense-reduce accumulation,
the Noam schedule, checkpointing, and (optionally) data parallelism over
a ``torch.distributed`` world, then decodes two samples greedily.  The
densify kernel is on the exchange path (``use_kernel=True``).  Runs on
the card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/train_nmt_torch.py --steps 300

Data parallel (the paper's `mpirun -np 8` equivalent), one rank a card:

    PYTHONPATH=src torchrun --nproc-per-node 8 \\
        examples/train_nmt_torch.py --steps 300 --horovod

Quick sanity run: --steps 20 --small
"""
import argparse

import torch
import torch.distributed as dist

from repro_torch.checkpoint import ShardedCheckpoint
from repro_torch.configs import get_config
from repro_torch.core import DistributedOptimizer, ExchangeConfig
from repro_torch.data import make_pipeline
from repro_torch.launch.train import (init_distributed, meta_worker_grads,
                                      resolve_device)
from repro_torch.models import build_model
from repro_torch.optim import adamw, noam_schedule
from repro_torch.serving import ServeEngine
from repro_torch.training import Trainer, TrainerConfig, make_train_step
from repro_torch.tree import tree_flatten


def nmt_100m():
    """~100M-param transformer: the paper's architecture, one size down
    (between 'base' 65M and 'big' 210M)."""
    return get_config("transformer-big").with_(
        name="transformer-100m", d_model=768, n_heads=12, n_kv_heads=12,
        d_ff=3072, head_dim=64, dtype="float32")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch-per-worker", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--small", action="store_true",
                    help="reduced config (CI / smoke)")
    ap.add_argument("--horovod", action="store_true",
                    help="data parallel over the torch.distributed world "
                         "(torchrun's; a world of 1 without it)")
    ap.add_argument("--sparse-gather", action="store_true",
                    help="use the pathological strategy instead of the fix")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("transformer-big").reduced() if args.small else \
        nmt_100m()
    model = build_model(cfg)
    params = model.init(seed=0, device=device)
    n_params = sum(p.numel() for p in tree_flatten(params)[0])

    rank, world, created, group = 0, 1, False, None
    if args.horovod:
        rank, world, created = init_distributed(device)
        group = dist.group.WORLD
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"{cfg.name}: {n_params/1e6:.1f}M params, "
        f"strategy={'gather' if args.sparse_gather else 'dense_reduce'}")
    try:
        opt = DistributedOptimizer(
            adamw(noam_schedule(cfg.d_model,
                                warmup_steps=max(args.steps // 4, 50))),
            exchange=ExchangeConfig(
                sparse_as_dense=not args.sparse_gather,
                fusion_threshold=128 * 1024 * 1024,  # HOROVOD_FUSION_THRESHOLD
                use_kernel=True),
            group=group)
        step = make_train_step(model, opt, sparse_embedding=True)
        if args.horovod:
            say(f"horovod mode: {world} workers")

        pipe = make_pipeline(cfg, batch_per_host=args.batch_per_worker * world,
                             seq_len=args.seq_len, task="translation")
        meta = meta_worker_grads(args, model, pipe, sparse_embedding=True)
        trainer = Trainer(model, step, pipe, TrainerConfig(
            total_steps=args.steps, log_every=max(args.steps // 20, 1),
            checkpoint_every=args.steps // 3 if args.checkpoint_dir else 0,
            checkpoint_dir=args.checkpoint_dir),
            device=device, rank=rank, world=world,
            checkpoint=ShardedCheckpoint(opt.plan(meta), group))
        res = trainer.run(params, opt.init(params),
                          opt.init_exchange_state(meta, device=device),
                          log=say)
    finally:
        if created:
            dist.destroy_process_group()

    # quick greedy decode demo on the trained model
    eng = ServeEngine(model, res["params"], cache_len=args.seq_len + 8)
    prompts = pipe.batch_at(10_000)["tokens"][:2, :args.seq_len // 2]
    out = eng.generate(prompts, max_new=8)
    say("sample generations (token ids):")
    for row in out:
        say("  ", row.tolist())
    return {"history": res["history"], "generations": out}


if __name__ == "__main__":
    main()
