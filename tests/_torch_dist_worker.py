"""Workers for the port's multi-process tests (gloo on the CPU).

Imported by the spawned processes of tests/test_torch_exchange.py
(``run``) and tests/test_torch_overlap.py (``run_overlap``); it imports
torch and the port only.
"""
import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core import DistributedOptimizer, ExchangeConfig
from repro_torch.core.indexed_slices import IndexedSlices
from repro_torch.data import make_pipeline
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.training import (LossScaler, grad_contributions,
                                  make_scaled_train_step, make_train_step)
from repro_torch.training.microbatch import _scale_grad_tree
from repro_torch.tree import tree_flatten

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


#: the overlap modes the world-of-2 test holds against the fused step
OVERLAPS = (False, "staged", "backward")


def run_overlap(rank: int, world: int, port: int, out_dir: str) -> None:
    """Per overlap mode and wire (identity, int8+ef): two training steps
    of the reduced transformer-big, and one loss-scaled step at M = 2;
    every rank saves its final parameters, Adam moments and residuals."""
    torch.set_num_threads(2)         # two ranks share the host's cores
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        cfg = get_config("transformer-big").reduced()
        model = build_model(cfg)
        pipe = make_pipeline(cfg, 2 * world, 8, seed=0)

        def batch_at(step):
            return {k: torch.from_numpy(np.ascontiguousarray(
                v[2 * rank:2 * rank + 2]))
                for k, v in pipe.batch_at(step).items()}

        def record(tag, params, opt_state, ex_state):
            results[f"{tag}/params"] = tree_flatten(params)[0]
            results[f"{tag}/mu"] = tree_flatten(opt_state.mu)[0]
            results[f"{tag}/nu"] = tree_flatten(opt_state.nu)[0]
            results[f"{tag}/residuals"] = [
                r for r in ex_state.bucket_states
                if isinstance(r, torch.Tensor)]

        results = {}
        for codec in ("identity", "int8+ef"):
            for overlap in OVERLAPS:
                opt = DistributedOptimizer(
                    adamw(1e-3), exchange=ExchangeConfig(
                        sparse_as_dense=True, codec=codec, overlap=overlap,
                        use_kernel=True), group=dist.group.WORLD)
                step = make_train_step(model, opt, sparse_embedding=True)
                params = model.init(seed=0, device="cpu")
                opt_state = opt.init(params)
                ex = opt.init_exchange_state(grad_contributions(
                    model, params, batch_at(0), sparse_embedding=True)[0])
                for k in range(2):
                    params, opt_state, ex, _ = step(params, opt_state, ex,
                                                    batch_at(k))
                record(f"{codec}/{overlap}", params, opt_state, ex)
            for overlap in OVERLAPS:
                opt = DistributedOptimizer(
                    adamw(1e-3), exchange=ExchangeConfig(
                        sparse_as_dense=True, codec=codec, overlap=overlap,
                        use_kernel=True), group=dist.group.WORLD)
                step = make_scaled_train_step(model, opt, LossScaler(),
                                              n_microbatches=2,
                                              sparse_embedding=True)
                params = model.init(seed=0, device="cpu")
                g = grad_contributions(model, params, batch_at(0),
                                       sparse_embedding=True)[0]
                ex = opt.init_exchange_state(_scale_grad_tree(
                    g, torch.tensor(1.0)))
                params, opt_state, _, ex, m = step(
                    params, opt.init(params), LossScaler().init(device="cpu"),
                    ex, batch_at(0))
                assert not bool(m["overflow"])
                record(f"scaled/{codec}/{overlap}", params, opt_state, ex)
        torch.save(results, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()
