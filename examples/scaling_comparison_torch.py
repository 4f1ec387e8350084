"""The paper's core experiment at laptop scale on the PyTorch port: per
worker count, a comparison of the accumulation/exchange strategies
(buffer size, planned wire bytes, measured step time, model equality).

All static numbers come from the ExchangePlan, the same schedule the
runtime collectives execute.  Beyond the paper's two strategies, any
codec/backend combination from the registries can be compared with
``--codec`` / ``--backend`` / ``--reduce-scatter`` (adds a third row).
The workers are the ranks of a ``torch.distributed`` world (gloo on the
CPU, NCCL on the card, one rank a card); without torchrun it is a world
of 1.  The densify kernel is on the exchange path (``use_kernel=True``).

    PYTHONPATH=src torchrun --nproc-per-node 8 \\
        examples/scaling_comparison_torch.py --device cpu \\
        [--reduce-scatter] [--codec bf16|int8] [--backend flat|ringsim]
"""
import argparse
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core import DistributedOptimizer, ExchangeConfig
from repro_torch.data import make_pipeline
from repro_torch.launch.train import init_distributed, resolve_device
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.training import make_train_step
from repro_torch.training.gradients import grad_contributions
from repro_torch.tree import tree_flatten, tree_map


def max_diff(a, b) -> float:
    return max(float((x.float() - y.float()).abs().max()) for x, y in zip(
        tree_flatten(a)[0], tree_flatten(b)[0]))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reduce-scatter", action="store_true",
                    help="add a dense_reduce row exchanged via "
                         "reduce-scatter + allgather")
    ap.add_argument("--wire-dtype", default=None,
                    choices=[None, "bf16", "bfloat16"],
                    help="deprecated spelling of --codec")
    ap.add_argument("--codec", default=None,
                    help="WireCodec for the extra row (bf16, f16, int8)")
    ap.add_argument("--backend", default=None,
                    help="CollectiveBackend for the extra row (flat, "
                         "ringsim)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.wire_dtype and not args.codec:
        args.codec = args.wire_dtype
    device = resolve_device(args.device)

    rank, n_dev, created = init_distributed(device)
    say = print if rank == 0 else (lambda *a, **k: None)
    try:
        cfg = get_config("transformer-big").reduced()
        model = build_model(cfg)
        params = model.init(seed=0, device=device)
        pipe = make_pipeline(cfg, batch_per_host=2 * n_dev, seq_len=32)

        def batch_at(i):     # this rank's rows of the global batch
            return {k: torch.from_numpy(v[2 * rank:2 * rank + 2]).to(device)
                    for k, v in pipe.batch_at(i).items()}
        batch = batch_at(0)
        grads = grad_contributions(model, params, batch,
                                   sparse_embedding=True)[0]

        strategies = [
            ("sparse_gather", ExchangeConfig(sparse_as_dense=False,
                                             use_kernel=True)),
            ("dense_reduce", ExchangeConfig(sparse_as_dense=True,
                                            use_kernel=True))]
        if args.reduce_scatter or args.codec or args.backend:
            extra = ExchangeConfig(sparse_as_dense=True,
                                   reduce_scatter=args.reduce_scatter,
                                   codec=args.codec or "identity",
                                   backend=args.backend or "flat",
                                   use_kernel=True)
            name = "dense" + ("_rs" if args.reduce_scatter else "") + \
                (f"_{extra.codec}" if extra.codec != "identity" else "") + \
                (f"_{extra.backend}" if extra.backend != "flat" else "")
            strategies.append((name, extra))

        say(f"{n_dev} workers ({dist.get_backend()}) — {cfg.name}  "
            f"(run under torchrun --nproc-per-node N to change)")
        say(f"{'strategy':15s} {'buffer@N':>12s} {'wire/worker':>12s} "
            f"{'n_coll':>7s} {'ms/step':>9s} {'final loss':>10s}")

        final_params, rows = {}, {}
        for name, ex in strategies:
            opt = DistributedOptimizer(adamw(3e-3), exchange=ex,
                                       group=dist.group.WORLD)
            stats = opt.exchange_stats(grads, n_workers=n_dev)
            step = make_train_step(model, opt, sparse_embedding=True)
            # the step updates its arguments in place: each row a copy
            p = tree_map(torch.clone, params)
            s, e = opt.init(p), opt.init_exchange_state(grads)
            p, s, e, m = step(p, s, e, batch)            # first step
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            for i in range(1, 6):
                p, s, e, m = step(p, s, e, batch_at(i))
            loss = float(m["loss"])                      # waits for it
            dt = (time.perf_counter() - t0) / 5
            final_params[name] = p
            rows[name] = {"accumulated_bytes": stats.accumulated_bytes,
                          "wire_bytes": stats.wire_bytes,
                          "n_collectives": stats.n_collectives,
                          "ms_per_step": dt * 1e3, "final_loss": loss}
            say(f"{name:15s} {stats.accumulated_bytes/1e6:10.1f}MB "
                f"{stats.wire_bytes/1e6:10.1f}MB {stats.n_collectives:7d} "
                f"{dt*1e3:9.1f} {loss:10.4f}")

        diff = max_diff(final_params["sparse_gather"],
                        final_params["dense_reduce"])
        say(f"\nmax param difference: {diff:.2e} — same model, "
            f"{'(paper Fig. 12 invariance holds)' if diff < 1e-4 else 'BUG'}")
        diffs = {"sparse_gather": diff}
        for name in final_params:
            if name in ("sparse_gather", "dense_reduce"):
                continue
            d = max_diff(final_params[name], final_params["dense_reduce"])
            tol = 5e-2 if ("bf" in name or "f16" in name
                           or "int8" in name) else 1e-4
            diffs[name] = d
            say(f"{name} vs dense_reduce: {d:.2e} "
                f"({'within wire tolerance' if d < tol else 'BUG'})")
    finally:
        if created:
            dist.destroy_process_group()
    return {"n_workers": n_dev, "rows": rows, "max_param_diff": diffs}


if __name__ == "__main__":
    main()
