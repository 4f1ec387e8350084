"""Continuous-batching serving on the PyTorch port: a stream of
variable-length requests served through paged decode slots — block-pool
KV cache, chunked prefill interleaved with decode, priority/deadline
scheduling, and a zero-downtime weight hot swap streamed through the
ExchangePlan while requests are in flight.  Runs on the card unless
``--device cpu`` is given.

    PYTHONPATH=src python examples/continuous_serving_torch.py \\
        [--arch zamba2-7b] [--slots 4] [--requests 12] [--blocks 16]

``--swap-codec`` sets the hot swap's wire (the reference streams the
identity wire; ``int8`` encodes each bucket with the quantize kernel).
"""
import argparse
import time

import numpy as np

from repro_torch.configs import get_config
from repro_torch.launch.train import resolve_device
from repro_torch.models import build_model
from repro_torch.serving import ContinuousBatcher, Request, SLOConfig
from repro_torch.serving.paged_cache import dense_cache_bytes

COUNTERS = ("sched/steps", "sched/admitted", "sched/completed",
            "sched/preempted", "sched/tokens")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--cache-len", type=int, default=48)
    ap.add_argument("--blocks", type=int, default=None,
                    help="pool size in blocks (default: full coverage; "
                         "smaller values trade memory for preemptions)")
    ap.add_argument("--hot-swap", action="store_true",
                    help="stream a second checkpoint in mid-run")
    ap.add_argument("--swap-codec", default="identity",
                    help="WireCodec of the hot swap's buckets")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch).reduced()
    model = build_model(cfg)
    params = model.init(seed=0, device=device)
    rng = np.random.default_rng(0)

    batcher = ContinuousBatcher(
        model, params, n_slots=args.slots, cache_len=args.cache_len,
        n_blocks=args.blocks,
        slo=SLOConfig(ttft_target_ms=500.0, tpot_target_ms=100.0,
                      prefill_chunk=4))
    for i in range(args.requests):
        plen = int(rng.integers(3, 10))
        batcher.submit(Request(
            uid=i,
            prompt=rng.integers(4, cfg.vocab, (plen,)).astype(np.int32),
            max_new=int(rng.integers(4, 12)),
            priority=int(rng.integers(0, 3))))

    stream = None
    if args.hot_swap:
        stream = batcher.begin_hot_swap(model.init(seed=7, device=device),
                                        codec=args.swap_codec)
        print(f"hot swap started: {stream.n_buckets} buckets, "
              f"one per scheduler step")

    t0 = time.perf_counter()
    done = batcher.run()
    dt = time.perf_counter() - t0
    mc = batcher.metrics
    paged = batcher.paged.pool_bytes()
    dense = dense_cache_bytes(model, args.slots, batcher.paged.view_len)
    print(f"{cfg.name}: {len(done)} requests through {args.slots} paged "
          f"slots (params v{batcher.params_version})")
    print(f"  {mc.counter('sched/steps').value} batch steps, utilisation "
          f"{batcher.utilisation:.0%}, "
          f"{mc.counter('sched/preempted').value} preemptions, "
          f"{dt:.2f}s wall")
    print(f"  paged cache {paged / 1e3:.0f} kB vs dense "
          f"{dense / 1e3:.0f} kB ({paged / dense:.0%})")
    print(f"  TTFT p99 {mc.histogram('serve/ttft').summary()['p99_ms']:.1f} ms, "
          f"TPOT p99 {mc.histogram('serve/tpot').summary()['p99_ms']:.1f} ms")
    for req in sorted(done, key=lambda r: r.uid)[:5]:
        print(f"  req{req.uid} (prio {req.priority}): "
              f"prompt[{len(req.prompt)}] -> {req.output}")
    return {"outputs": {r.uid: list(r.output) for r in done},
            "counters": {k: mc.counter(k).value for k in COUNTERS},
            "params_version": batcher.params_version,
            "swap_buckets": stream.n_buckets if stream else 0}


if __name__ == "__main__":
    main()
