"""Quickstart on the PyTorch port: the paper's fix in 60 lines.

Builds the paper's transformer (reduced), trains it twice — once with
TensorFlow-style assumed-sparse accumulation (gather), once with the
paper's sparse_as_dense fix (reduce) — and shows that the models are
identical while the accumulated-tensor sizes are wildly different.  The
densify kernel is on the exchange path (``use_kernel=True``, as the
launcher sets it).  Runs on the card unless ``--device cpu`` is given;
``--steps`` sets each training run's length (the reference's 30).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.core import DistributedOptimizer, ExchangeConfig
from repro_torch.data import make_pipeline
from repro_torch.launch.train import resolve_device
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.training import Trainer, TrainerConfig, make_train_step
from repro_torch.training.gradients import grad_contributions
from repro_torch.tree import tree_flatten, tree_map


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("transformer-big").reduced()
    model = build_model(cfg)
    params = model.init(seed=0, device=device)
    pipe = make_pipeline(cfg, batch_per_host=8, seq_len=32, task="copy")

    print(f"model: {cfg.name} ({cfg.n_layers}L d={cfg.d_model} "
          f"vocab={cfg.vocab}, tied embeddings)")

    # --- what does each strategy accumulate? -----------------------------
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in pipe.batch_at(0).items()}
    grads = grad_contributions(model, params, batch,
                               sparse_embedding=True)[0]
    buffers = {}
    for name, ex in [
            ("sparse gather (TF default)", ExchangeConfig(use_kernel=True)),
            ("dense reduce (the paper's fix)",
             ExchangeConfig(sparse_as_dense=True, use_kernel=True)),
            ("dense reduce + int8 wire",
             ExchangeConfig(sparse_as_dense=True, codec="int8",
                            use_kernel=True))]:
        opt = DistributedOptimizer(adamw(3e-3), exchange=ex)
        stats = opt.exchange_stats(grads, n_workers=64)
        buffers[name] = stats
        print(f"  {name:33s}: accumulated buffer at 64 workers = "
              f"{stats.accumulated_bytes/1e6:8.1f} MB, "
              f"wire = {stats.wire_bytes/1e6:8.1f} MB/worker  "
              f"[{stats.strategy}]")

    # --- and does the choice change the model? NO. -----------------------
    results = {}
    for name, sad in [("gather", False), ("reduce", True)]:
        opt = DistributedOptimizer(
            adamw(3e-3), exchange=ExchangeConfig(sparse_as_dense=sad,
                                                 use_kernel=True))
        step = make_train_step(model, opt, sparse_embedding=True)
        tr = Trainer(model, step, pipe,
                     TrainerConfig(total_steps=args.steps,
                                   log_every=max(args.steps // 3, 1)),
                     device=device)
        print(f"training with {name} accumulation:")
        # the step updates its arguments in place: each run its own copy
        p0 = tree_map(torch.clone, params)
        res = tr.run(p0, opt.init(p0), opt.init_exchange_state(grads),
                     log=lambda s: print("   ", s))
        results[name] = res["params"]
    diff = max(float((a.float() - b.float()).abs().max()) for a, b in zip(
        tree_flatten(results["gather"])[0],
        tree_flatten(results["reduce"])[0]))
    print(f"max param difference between strategies: {diff:.2e}  "
          f"(identical models, {'OK' if diff < 1e-4 else 'MISMATCH'})")
    return {"buffers": buffers, "max_param_diff": diff}


if __name__ == "__main__":
    main()
