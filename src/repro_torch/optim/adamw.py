"""AdamW over parameter trees (``repro.optim.adamw``): f32 state and f32
update math whatever the parameters' dtype."""
from __future__ import annotations

from typing import Callable, NamedTuple, Union

import torch

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


def adamw(lr: Union[float, Callable] = 1e-3, b1: float = 0.9,
          b2: float = 0.98, eps: float = 1e-9,
          weight_decay: float = 0.0) -> Optimizer:
    """AdamW with the paper's transformer defaults (b2=0.98, eps=1e-9)."""
    sched = _as_schedule(lr)

    def _math(g, m, v, p, step):
        lr_t = sched(step)
        t = step.to(torch.float32)
        bc1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                         device=t.device), t)
        bc2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                         device=t.device), t)
        g = g.to(torch.float32)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mhat = m / bc1
        vhat = v / bc2
        u = -lr_t * (mhat / (torch.sqrt(vhat) + eps)
                     + weight_decay * p.to(torch.float32))
        return u, m, v

    def init(params):
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        leaves = tree_flatten(params)[0]
        device = leaves[0].device if leaves else "cpu"
        return AdamState(step=torch.zeros((), dtype=torch.int32,
                                          device=device),
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

    return Optimizer(init=init, update=update)
