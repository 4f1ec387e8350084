"""AdamW and SGD-momentum over parameter trees (``repro.optim.adamw``):
f32 update math whatever the parameters' or the state's dtype."""
from __future__ import annotations

from typing import Callable, NamedTuple, Union

import torch

from repro_torch.core import comm
from repro_torch.optim.base import Optimizer
from repro_torch.tree import tree_flatten, tree_map, tree_unflatten


class AdamState(NamedTuple):
    step: torch.Tensor   # int32 scalar
    mu: object           # tree like params
    nu: object           # tree like params


def _as_schedule(lr) -> Callable:
    if callable(lr):
        return lr
    return lambda step: torch.tensor(lr, dtype=torch.float32,
                                     device=step.device)


def _tree_device(params):
    leaves = tree_flatten(params)[0]
    return leaves[0].device if leaves else "cpu"


def adamw(lr: Union[float, Callable] = 1e-3, b1: float = 0.9,
          b2: float = 0.98, eps: float = 1e-9,
          weight_decay: float = 0.0,
          state_dtype: str = "float32") -> Optimizer:
    """AdamW with the paper's transformer defaults (b2=0.98, eps=1e-9).

    ``state_dtype`` sets the storage dtype of the mu/nu EMA buffers
    (``"bfloat16"`` halves the optimizer state); the update math is f32
    after the upcast, so the replicated and the ZeRO-1 sharded paths
    stay element for element the same for a given ``state_dtype``."""
    sched = _as_schedule(lr)
    sdtype = comm.torch_dtype(state_dtype)

    def _math(g, m, v, p, step):
        # the one copy of the AdamW element math: the tree update, the
        # flat ZeRO-1 shard update and the gather-leaf update all route
        # here, so the sharded path is bitwise the replicated one
        lr_t = sched(step)
        t = step.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                         device=t.device), t)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                         device=t.device), t)
        g = g.to(torch.float32)
        m = b1 * m.to(torch.float32) + (1 - b1) * g
        v = b2 * v.to(torch.float32) + (1 - b2) * g * g
        mhat = m / bc1
        vhat = v / bc2
        u = -lr_t * (mhat / (torch.sqrt(vhat) + eps)
                     + weight_decay * p.to(torch.float32))
        return u, m.to(sdtype), v.to(sdtype)

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=sdtype)
        return AdamState(step=torch.zeros((), dtype=torch.int32,
                                          device=_tree_device(params)),
                         mu=tree_map(zeros, params),
                         nu=tree_map(zeros, params))

    def update(grads, state, params):
        step = state.step + 1
        flat_g, treedef = tree_flatten(grads)
        out = [_math(g, m, v, p, step) for g, m, v, p in zip(
            flat_g, tree_flatten(state.mu)[0], tree_flatten(state.nu)[0],
            tree_flatten(params)[0])]
        updates = tree_unflatten(treedef, [o[0] for o in out])
        mu = tree_unflatten(treedef, [o[1] for o in out])
        nu = tree_unflatten(treedef, [o[2] for o in out])
        return updates, AdamState(step=step, mu=mu, nu=nu)

    def flat_init(n_elems: int, *, device):
        return (torch.zeros((n_elems,), dtype=sdtype, device=device),
                torch.zeros((n_elems,), dtype=sdtype, device=device))

    def flat_update(g, state_tensors, p, step):
        m, v = state_tensors
        u, m, v = _math(g, m, v, p, step)
        return p.to(torch.float32) + u, (m, v)

    return Optimizer(init=init, update=update, flat_init=flat_init,
                     flat_update=flat_update, state_dtype=state_dtype)


class MomentumState(NamedTuple):
    step: torch.Tensor
    velocity: object


def sgd_momentum(lr: Union[float, Callable] = 1e-2,
                 momentum: float = 0.9) -> Optimizer:
    """SGD with momentum (f32 velocity); it has no flat-shard path, so
    ZeRO-1 refuses it."""
    sched = _as_schedule(lr)

    def init(params):
        return MomentumState(
            step=torch.zeros((), dtype=torch.int32,
                             device=_tree_device(params)),
            velocity=tree_map(
                lambda p: torch.zeros_like(p, dtype=torch.float32), params))

    def update(grads, state, params):
        step = state.step + 1
        lr_t = sched(step)
        vel = tree_map(lambda v, g: momentum * v + g.to(torch.float32),
                       state.velocity, grads)
        updates = tree_map(lambda v: -lr_t * v, vel)
        return updates, MomentumState(step=step, velocity=vel)

    return Optimizer(init=init, update=update)
