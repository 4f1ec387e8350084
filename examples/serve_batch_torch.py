"""Batched serving on the PyTorch port: prefill a batch of prompts,
decode with a KV cache (full and sliding-window ring-buffer variants),
across the architecture families — with latency histograms (TTFT,
per-token) and an optional streamed weight hot swap between generations.
Runs on the card unless ``--device cpu`` is given.

    PYTHONPATH=src python examples/serve_batch_torch.py [--arch llama3.2-1b]

``--swap-codec`` sets the hot swap's wire (the reference streams the
identity wire; ``int8`` encodes each bucket with the quantize kernel).
"""
import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.launch.train import resolve_device
from repro_torch.models import build_model
from repro_torch.serving import ServeEngine
from repro_torch.telemetry.metrics import MetricsLogger


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b",
                    help="any assigned arch id (reduced variant is used)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--window", type=int, default=None,
                    help="sliding-window size (ring-buffer cache)")
    ap.add_argument("--hot-swap", action="store_true",
                    help="stream a refreshed checkpoint in bucket-by-"
                         "bucket, then generate again on the new params")
    ap.add_argument("--swap-codec", default="identity",
                    help="WireCodec of the hot swap's buckets")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    model = build_model(cfg)
    params = model.init(seed=0, device=device)
    rng = np.random.default_rng(0)
    prompts = rng.integers(4, cfg.vocab,
                           (args.batch, args.prompt_len)).astype(np.int32)

    cache_len = (args.window if args.window
                 else args.prompt_len + args.max_new + 1)
    eng = ServeEngine(model, params, cache_len=cache_len,
                      window=args.window, ring=args.window is not None,
                      metrics=MetricsLogger())
    t0 = time.perf_counter()
    out = eng.generate(prompts, max_new=args.max_new)
    dt = time.perf_counter() - t0
    n_tok = out.size
    print(f"{cfg.name}: batch={args.batch} prompt={args.prompt_len} "
          f"-> {out.shape[1]} new tokens each")
    print(f"cache: {'ring(window=%d)' % args.window if args.window else 'full'}"
          f", {n_tok} tokens in {dt:.2f}s ({n_tok/dt:.0f} tok/s incl. "
          f"prefill)")
    for name, s in eng.latency_summary().items():
        print(f"  {name}: p50 {s['p50_ms']:.1f} ms, p99 {s['p99_ms']:.1f} ms "
              f"(n={s['count']})")
    for i, row in enumerate(out):
        print(f"  seq{i}: {row.tolist()}")

    result = {"prompts": prompts, "tokens": out}
    if args.hot_swap:
        stream = eng.begin_hot_swap(model.init(seed=7, device=device),
                                    codec=args.swap_codec)
        while not eng.hot_swap_step():
            pass
        print(f"hot swap: {stream.n_buckets} buckets streamed, params "
              f"now v{eng.params_version}; regenerating")
        out2 = eng.generate(prompts, max_new=args.max_new)
        print(f"  new-params seq0: {out2[0].tolist()}")
        result.update(swap_buckets=stream.n_buckets, swap_tokens=out2)
    return result


if __name__ == "__main__":
    main()
