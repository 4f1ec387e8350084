#!/usr/bin/env python3
"""Which process-group backends take which collectives on CUDA tensors.

    python3 scripts/probe_collectives_cuda.py [--out probe.json]

Two probes, each in fresh processes on card 0:

  * nccl, a world of 1: ``all_reduce``, ``all_gather`` and
    ``reduce_scatter_tensor`` of a float8_e4m3fn and a uint8 tensor (the
    port carries float8 buffers as their uint8 bit patterns because the
    backends refuse float8);
  * gloo, a world of 2 ranks sharing the one card: ``all_reduce``,
    ``all_gather``, ``reduce_scatter_tensor`` and ``batch_isend_irecv``
    of f32 CUDA tensors, each in a world of its own (a refusal may end
    the process instead of raising), checked against the value it must
    give (NCCL refuses two ranks on one card, so a world above 1 on one
    card needs gloo to take CUDA tensors).

Prints one JSON object, ``{"nccl_world_1": {...}, "gloo_world_2_cuda":
{...}, "device": ..., "torch": ...}``, each entry "ok", the error's
first line, or how the process ended, and writes it to ``--out``.  Needs
a card.
"""
from __future__ import annotations

import argparse
import json
import socket
import sys
import warnings

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _try(fn) -> str:
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            fn()
        torch.cuda.synchronize()
        return "ok"
    except Exception as e:                    # the refusal is the result
        return f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"


def _nccl(rank, world, port, q):
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    out = {}
    for name, dt in (("float8_e4m3fn", torch.float8_e4m3fn),
                     ("uint8", torch.uint8)):
        x = torch.zeros(8, device="cuda").to(dt)
        out[f"all_reduce/{name}"] = _try(lambda: dist.all_reduce(x))
        out[f"all_gather/{name}"] = _try(lambda: dist.all_gather(
            [torch.empty_like(x)], x))
        out[f"reduce_scatter_tensor/{name}"] = _try(
            lambda: dist.reduce_scatter_tensor(torch.empty_like(x), x))
    dist.destroy_process_group()
    q.put(out)


def _gloo(rank, world, port, q, op):
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    x = torch.full((4,), float(rank + 1), device="cuda")

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        assert y.tolist() == [3.0] * 4

    def all_gather():
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        assert torch.cat(parts).tolist() == [1.0] * 4 + [2.0] * 4

    def reduce_scatter_tensor():
        y = torch.empty(2, device="cuda")
        dist.reduce_scatter_tensor(y, x)
        assert y.tolist() == [3.0, 3.0]

    def batch_isend_irecv():
        buf = torch.empty_like(x)
        for w in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, x, (rank + 1) % world),
                dist.P2POp(dist.irecv, buf, (rank - 1) % world)]):
            w.wait()
        assert buf.tolist() == [float((rank - 1) % world + 1)] * 4

    q.put(_try(locals()[op]))
    dist.destroy_process_group()


GLOO_OPS = ("all_reduce", "all_gather", "reduce_scatter_tensor",
            "batch_isend_irecv")


def _spawn(fn, world, *extra):
    """Each rank's result, or how its process ended when it put none."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _port()
    procs = [ctx.Process(target=fn, args=(r, world, port, q) + extra)
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
        if p.is_alive():
            p.kill()
            p.join()
    results = []
    while not q.empty():
        results.append(q.get())
    ended = [f"process ended with exit code {p.exitcode}" for p in procs
             if p.exitcode != 0]
    return results + ended


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="probe_collectives_cuda.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_collectives_cuda: needs a card", file=sys.stderr)
        return 1
    nccl = _spawn(_nccl, 1)
    result = {"device": torch.cuda.get_device_name(0),
              "torch": torch.__version__,
              "nccl_world_1": (nccl[0] if nccl and isinstance(nccl[0], dict)
                               else nccl),
              "gloo_world_2_cuda": {op: sorted(set(_spawn(_gloo, 2, op)))
                                    for op in GLOO_OPS}}
    print(json.dumps(result))
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
