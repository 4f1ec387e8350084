"""Worker for the port's multi-process exchange test (gloo on the CPU).

Imported by the spawned processes of tests/test_torch_exchange.py; it
imports torch and the port only.
"""
import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import DistributedOptimizer, ExchangeConfig
from repro_torch.core.indexed_slices import IndexedSlices
from repro_torch.optim import adamw

VOCAB, D = 64, 8
#: int8 exchanges, each run twice in a row (the state threaded through)
INT8_CONFIGS = {
    "int8_dense_reduce": dict(sparse_as_dense=True, codec="int8"),
    "int8_sparse_gather": dict(codec="int8"),
    "int8+ef_dense_reduce": dict(sparse_as_dense=True, codec="int8+ef"),
    "int8+ef_fused": dict(sparse_as_dense=True, codec="int8+ef",
                          fusion_threshold=1 << 20),
}


def worker_grads(rank: int, exchange: int = 0):
    """A small grad-contribution tree, different on every rank and every
    exchange: a tied embedding ([IndexedSlices, dense]) and two dense
    leaves."""
    rng = np.random.default_rng(100 + rank + 1000 * exchange)
    rows = 12
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    return {
        "embedding": [IndexedSlices(
            torch.from_numpy(rng.integers(0, VOCAB, rows).astype(np.int32)),
            t(rows, D), (VOCAB, D)), t(VOCAB, D)],
        "layers": {"w": t(3, D, 5), "b": t(5)},
    }


def run(rank: int, world: int, port: int, out_dir: str) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        g = worker_grads(rank)
        results = {}
        for name, cfg in (
                ("dense_reduce", ExchangeConfig(sparse_as_dense=True,
                                                use_kernel=True)),
                ("sparse_gather", ExchangeConfig(use_kernel=True)),
                ("dense_reduce_fused", ExchangeConfig(
                    sparse_as_dense=True, use_kernel=True,
                    fusion_threshold=1 << 20))):
            avg = DistributedOptimizer(adamw(1e-3), exchange=cfg,
                                       group=dist.group.WORLD).exchange(g)[0]
            local = DistributedOptimizer(adamw(1e-3), exchange=cfg,
                                         group=None).exchange(g)[0]
            for key, tree in (("avg", avg), ("local", local)):
                results[f"{name}/{key}/embedding"] = tree["embedding"]
                results[f"{name}/{key}/w"] = tree["layers"]["w"]
                results[f"{name}/{key}/b"] = tree["layers"]["b"]
        for name, kw in INT8_CONFIGS.items():
            opt = DistributedOptimizer(
                adamw(1e-3), exchange=ExchangeConfig(use_kernel=True, **kw),
                group=dist.group.WORLD)
            state = opt.init_exchange_state(g)
            for k in range(2):
                tree, state = opt.exchange(worker_grads(rank, k),
                                           state=state)
                results[f"{name}/{k}/embedding"] = tree["embedding"]
                results[f"{name}/{k}/w"] = tree["layers"]["w"]
                results[f"{name}/{k}/b"] = tree["layers"]["b"]
        torch.save(results, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()
