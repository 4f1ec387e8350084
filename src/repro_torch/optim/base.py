"""Minimal optimizer API over parameter trees (``repro.optim.base``)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """A gradient transformation: ``init(params) -> state``,
    ``update(grads, state, params) -> (updates, state)``.  ``updates``
    are ADDED to params (the update includes -lr).

    Optimizers that can run over a flat 1-D shard of the parameter
    vector (the ZeRO-1 layout: one contiguous slice of a fusion bucket)
    also provide:

    - ``flat_init(n_elems, *, device) -> tuple of state tensors`` (e.g.
      ``(mu, nu)``), each of shape ``(n_elems,)`` on ``device``;
    - ``flat_update(g, state_tensors, p, step) -> (new_p,
      new_state_tensors)``: ``g`` and ``p`` of any shape, ``step`` the
      post-increment step count, the math element for element that of
      ``update``, so a sharded update followed by an allgather is
      bitwise equal to the replicated update;
    - ``state_dtype``: the storage dtype of the EMA buffers (the math
      is f32 whatever it is).
    """
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], Tuple[Any, Any]]
    flat_init: Optional[Callable[..., Tuple[Any, ...]]] = None
    flat_update: Optional[Callable] = None
    state_dtype: str = "float32"


def apply_updates(params, updates):
    """``params + updates``, cast back to each parameter's dtype."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)
