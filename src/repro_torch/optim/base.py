"""Minimal optimizer API over parameter trees (``repro.optim.base``)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """A gradient transformation: ``init(params) -> state``,
    ``update(grads, state, params) -> (updates, state)``.  ``updates``
    are ADDED to params (the update includes -lr)."""
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]


def apply_updates(params, updates):
    """``params + updates``, cast back to each parameter's dtype."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)
