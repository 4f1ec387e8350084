"""Exchange autotuner CLI (the reference's ``dryrun --tune``).

Searches the ExchangeConfig space for a model, a worker count and a
bandwidth profile, prints the ranked table and caches the winner under
``--tune-cache``, where ``launch/train.py --tuned`` finds it.  The
gradient tree is a real one: the model's gradients at batch 2 x 32 from
seed 0.  ``--trials 0`` ranks with the cost model alone (no collective
runs); ``--trials N`` also times the analytic top-k end to end, N trials
each, in a ``torch.distributed`` world of exactly ``--audit-workers``
ranks (``torchrun --nproc-per-node P``; without torchrun, a world of 1).
Only rank 0 writes the artifact and ``--out``.

    PYTHONPATH=src python -m repro_torch.launch.tune --arch transformer-big \\
        --full-size --audit-workers 1 --trials 2 --top-k 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch transformer-big \\
        --dist horovod --tuned

Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.data import make_pipeline
from repro_torch.launch.train import init_distributed, resolve_device
from repro_torch.models import build_model
from repro_torch.training.gradients import grad_contributions
from repro_torch.tuning import available_profiles
from repro_torch.tuning.search import (DEFAULT_CACHE_DIR, artifact_path,
                                       config_to_dict, save_artifact,
                                       search)


def audit_grads(arch: str, reduced: bool, batch_per_worker: int,
                seq_len: int, device: torch.device):
    """A real gradient-contribution tree (seed-0 parameters, the
    pipeline's first batch), with the model, parameters and batch the
    measured trials run end to end."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    params = model.init(seed=0, device=device)
    pipe = make_pipeline(cfg, batch_per_host=batch_per_worker,
                         seq_len=seq_len)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in pipe.batch_at(0).items()}
    grads = grad_contributions(model, params, batch,
                               sparse_embedding=True)[0]
    return cfg, grads, model, params, batch


def run_tune(arch: str = "transformer-big", n_workers: int = 8,
             reduced: bool = True, profile: str = "ethernet",
             trials: int = 0, top_k: int = 5,
             cache_dir: str = DEFAULT_CACHE_DIR,
             batch_per_worker: int = 2, seq_len: int = 32,
             device: str = "cuda") -> Dict[str, Any]:
    """Search the space for this (model, P, profile) and cache the
    winner.  ``trials > 0`` joins (or starts) the ``torch.distributed``
    world, which must have ``n_workers`` ranks, and times the top-k."""
    dev = resolve_device(device)
    _, grads, model, params, batch = audit_grads(
        arch, reduced, batch_per_worker, seq_len, dev)
    created = False
    try:
        if trials > 0:
            _, world, created = init_distributed(dev)
            if world != n_workers:
                raise SystemExit(f"--trials {trials} times the candidates "
                                 f"on --audit-workers {n_workers} ranks, "
                                 f"but the world has {world} (run under "
                                 f"torchrun --nproc-per-node {n_workers})")
        res = search(grads, n_workers, profile=profile, trials=trials,
                     top_k=top_k, model=model, params=params, batch=batch)
        path = artifact_path(cache_dir, res.key)
        if _rank() == 0:
            save_artifact(res, cache_dir)
        if dist.is_initialized():
            dist.barrier()          # the artifact exists for every rank
    finally:
        if created:
            dist.destroy_process_group()
    return dict(
        arch=arch, reduced=reduced, n_workers=n_workers,
        profile=res.profile, trials=trials,
        key=res.key, tree_fingerprint=res.tree_fingerprint,
        artifact=path,
        winner=res.winner.label,
        winner_config=config_to_dict(res.winner.config),
        n_candidates=len(res.candidates),
        table=res.table(),
        ranking=[
            {"label": c.label, "predicted_us": c.predicted_us,
             "measured_us": c.measured_us, "error": c.error}
            for c in res.candidates],
    )


def _rank() -> int:
    if dist.is_initialized():
        return dist.get_rank()
    return int(os.environ.get("RANK", 0))


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.tune")
    ap.add_argument("--arch", default="transformer-big")
    ap.add_argument("--full-size", action="store_true",
                    help="the full (not reduced) config")
    ap.add_argument("--audit-workers", type=int, default=8,
                    help="the worker count P the search is for")
    ap.add_argument("--profile", default="ethernet",
                    help="BandwidthProfile preset name or JSON path "
                         f"(presets: {', '.join(available_profiles())})")
    ap.add_argument("--trials", type=int, default=0,
                    help="measured trials of each analytic leader "
                         "(0 = analytic only)")
    ap.add_argument("--top-k", type=int, default=5,
                    help="with --trials N: how many analytic leaders to "
                         "measure")
    ap.add_argument("--tune-cache", default=DEFAULT_CACHE_DIR,
                    help="tuning artifact directory")
    ap.add_argument("--out", default=None,
                    help="also write the result as JSON here")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    result = run_tune(arch=args.arch, n_workers=args.audit_workers,
                      reduced=not args.full_size, profile=args.profile,
                      trials=args.trials, top_k=args.top_k,
                      cache_dir=args.tune_cache, device=args.device)
    if _rank() == 0:
        print(result["table"])
        print(f"\nwinner: {result['winner']}")
        print(f"artifact: {result['artifact']}")
        if args.out:
            with open(args.out, "w") as f:
                json.dump(result, f, indent=2, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())
