"""Paged KV cache: a fixed block pool and per-slot block tables
(``repro.serving.paged_cache``).

The dense serving cache allocates ``n_slots * cache_len`` rows a layer up
front, so slot count and context length multiply.  Paging breaks that
product: KV rows live in a pool of ``n_blocks`` blocks of ``block_size``
tokens, and each slot owns an ordered block table mapping its logical
positions onto pool blocks.  Memory is bounded by the tokens in flight; a
finished request's blocks return to the free list at once
(free-on-finish), and the next request writes into recycled blocks with
no copy (its ``length`` restarts at 0, so stale rows stay behind the
attention mask).

The step stays the model's own ``decode_step``: ``gather_view`` builds a
dense-shaped view of each slot's blocks, the step runs on the view, and
``writeback`` copies only the new rows back into the pool.  Rows past a
slot's ``n_valid`` (padding in a mixed prefill and decode chunk, or an
empty slot's garbage) are left out on the host before any index reaches
the card, where the reference scatters them to an out-of-range block and
lets XLA drop them; so no index the card sees is out of range.

Cache leaves are classified by structure: a leaf whose shape changes with
``cache_len`` (axis 2 of ``(lead, batch, cache_len, ...)``) is paged;
everything else (recurrent state, the ``length`` vector) stays resident a
slot and is write-masked.  Leaves are named by their path as
``jax.tree_util.keystr`` writes it (``"['attn']['k']"``), so the
classification is the reference's set of strings.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, FrozenSet, List, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_leaves_with_path, tree_map_with_path


def cache_leaf_paths(model, n_slots: int) -> Tuple[str, ...]:
    """Paths of the cache leaves that scale with ``cache_len``, found by
    diffing two template caches on the meta device, so the
    classification follows whatever layout a family uses (k/v, MLA
    ckv/kr, the hybrid's attention segments)."""
    a = tree_leaves_with_path(model.init_cache(n_slots, 8, device="meta"))
    b = tree_leaves_with_path(model.init_cache(n_slots, 16, device="meta"))
    paged = []
    for (pa, la), (pb, lb) in zip(a, b):
        if pa != pb:
            raise ValueError(f"cache structure diverged: {pa} != {pb}")
        if la.shape != lb.shape:
            if not (la.dim() >= 3 and la.shape[2] == 8 and lb.shape[2] == 16):
                raise ValueError(f"cache leaf {pa} scales with cache_len "
                                 f"on an unexpected axis: {tuple(la.shape)} "
                                 f"vs {tuple(lb.shape)}")
            paged.append(pa)
    return tuple(paged)


def dense_cache_bytes(model, n_slots: int, cache_len: int) -> int:
    """Bytes of the dense ``init_cache(n_slots, cache_len)``: the baseline
    the paged pool is measured against."""
    tree = model.init_cache(n_slots, cache_len, device="meta")
    return _nbytes(tree)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size()
               for _, t in tree_leaves_with_path(tree))


@dataclasses.dataclass
class PagedKVCache:
    """Block pool, block tables and per-slot resident state.

    The free list and the block tables are host (numpy) bookkeeping;
    ``state`` is the cache tree on ``device`` that the step reads through
    ``gather_view`` and updates through ``writeback``.  ``view_len =
    max_blocks_per_slot * block_size`` is the context width every slot
    sees: callers keep ``length + chunk <= view_len`` (``ensure`` holds
    the block side).  Resident leaves are replaced, never written in
    place; the pool's leaves are written in place by ``writeback``."""
    model: Any
    n_slots: int
    block_size: int
    n_blocks: int
    max_blocks_per_slot: int
    device: Any

    def __post_init__(self):
        if self.n_blocks < self.n_slots:
            raise ValueError(f"pool of {self.n_blocks} blocks cannot give "
                             f"{self.n_slots} slots one block each")
        self.device = torch.device(self.device)
        self._paged: FrozenSet[str] = frozenset(
            cache_leaf_paths(self.model, self.n_slots))
        template = self.model.init_cache(self.n_slots, self.block_size,
                                         device=self.device)
        # a fresh request's resident leaves, built once for every refill
        self._fresh: Dict[str, torch.Tensor] = {
            p: leaf for p, leaf in tree_leaves_with_path(template)
            if p not in self._paged}
        self.state = tree_map_with_path(self._to_pool, template)
        # host bookkeeping: table entry n_blocks == "no block" sentinel
        self.block_tables = np.full(
            (self.n_slots, self.max_blocks_per_slot), self.n_blocks,
            np.int32)
        self.slot_blocks: List[List[int]] = [[] for _ in range(self.n_slots)]
        self.free: List[int] = list(range(self.n_blocks - 1, -1, -1))

    def _to_pool(self, path: str, leaf: torch.Tensor) -> torch.Tensor:
        if path not in self._paged:
            return leaf
        # (lead, B, block_size, *rest) -> (lead, n_blocks, block_size,
        # *rest): one physical block a pool row
        return torch.zeros((leaf.shape[0], self.n_blocks)
                           + tuple(leaf.shape[2:]), dtype=leaf.dtype,
                           device=leaf.device)

    @property
    def view_len(self) -> int:
        return self.max_blocks_per_slot * self.block_size

    @property
    def n_free_blocks(self) -> int:
        return len(self.free)

    def pool_bytes(self) -> int:
        """Device bytes of the paged state (pool and resident leaves)."""
        return _nbytes(self.state)

    # -- block accounting ----------------------------------------------------
    def ensure(self, slot: int, n_tokens: int) -> bool:
        """Grow ``slot``'s table to cover ``n_tokens`` logical positions.
        Returns False, allocating nothing, when the pool is dry: the
        scheduler's preemption trigger."""
        need = -(-n_tokens // self.block_size)
        if need > self.max_blocks_per_slot:
            raise ValueError(f"request needs {need} blocks > "
                             f"max_blocks_per_slot={self.max_blocks_per_slot}"
                             f" (raise max_len or block budget)")
        have = len(self.slot_blocks[slot])
        if need - have > len(self.free):
            return False
        for i in range(have, need):
            blk = self.free.pop()
            self.slot_blocks[slot].append(blk)
            self.block_tables[slot, i] = blk
        return True

    def release(self, slot: int) -> None:
        """Free-on-finish: all of ``slot``'s blocks back to the pool."""
        self.free.extend(reversed(self.slot_blocks[slot]))
        self.slot_blocks[slot] = []
        self.block_tables[slot, :] = self.n_blocks

    def reset(self, mask) -> None:
        """Copy-free refill of the slots where ``mask`` (n_slots,) is set:
        their ``length`` zeroed and their resident state re-initialised;
        the pool is not touched (stale rows stay behind the mask)."""
        self.state = _reset_resident(self._paged, self.state, self._fresh,
                                     mask)

    def reset_slot(self, slot: int) -> None:
        mask = np.zeros((self.n_slots,), bool)
        mask[slot] = True
        self.reset(mask)

    def tables(self) -> torch.Tensor:
        return torch.as_tensor(self.block_tables, device=self.device)


def gather_view(state: Dict, block_tables, paged_paths: FrozenSet[str]
                ) -> Dict:
    """The dense-shaped cache each slot's block table describes: pool
    (lead, n_blocks, bs, *rest) -> view (lead, n_slots, max_blocks * bs,
    *rest).  Sentinel entries clamp onto the last block, as the
    reference's: garbage the length mask hides."""
    def gather(path, leaf):
        if path not in paged_paths:
            return leaf
        tables = torch.as_tensor(block_tables, device=leaf.device)
        b, mb = tables.shape
        idx = tables.clamp(0, leaf.shape[1] - 1).reshape(-1)
        v = leaf.index_select(1, idx)          # (lead, B * mb, bs, ...)
        return v.reshape((leaf.shape[0], b, mb * leaf.shape[2])
                         + tuple(leaf.shape[3:]))
    return tree_map_with_path(gather, state)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu()
    return np.asarray(x, np.int64)


def writeback(state: Dict, new_view: Dict, block_tables, pos0, n_valid,
              chunk: int, paged_paths: FrozenSet[str], block_size: int,
              n_blocks: int) -> Dict:
    """Copy the step's new rows back into the pool.

    For each slot, rows ``[pos0, pos0 + min(n_valid, chunk))`` of the
    view are real; they are listed on the host (``pos0``, ``n_valid`` and
    ``block_tables`` are read there: pass numpy arrays to keep the card
    from waiting) and copied with one indexed write a paged leaf, in
    place.  Rows the reference drops (past ``n_valid``, or on a sentinel
    block) are never listed, so every index is in range.  Resident leaves
    are write-masked a slot (new tensors), and ``length`` becomes
    ``pos0 + n_valid`` where ``n_valid`` > 0 and stays where it is 0 (the
    reference's ``pos0 + n_valid`` whenever ``pos0`` is the state's
    length)."""
    pos0_h, valid_h = _host(pos0), _host(n_valid)
    tables_h = _host(block_tables)
    b = pos0_h.shape[0]
    take = np.minimum(valid_h, chunk).clip(0)
    slots = np.repeat(np.arange(b), take)
    pos = pos0_h[slots] + (np.arange(take.sum())
                           - np.repeat(np.cumsum(take) - take, take))
    blk_idx = np.clip(pos // block_size, 0, tables_h.shape[1] - 1)
    blk = tables_h[slots, blk_idx]
    ok = (blk >= 0) & (blk < n_blocks) \
        & (pos < tables_h.shape[1] * block_size)
    rows = np.stack([slots[ok], pos[ok], blk[ok], pos[ok] % block_size])
    active = valid_h > 0
    dev = state["length"].device
    rows_t = torch.as_tensor(rows, device=dev)
    active_t = torch.as_tensor(active, device=dev)

    def scatter(path, pool, view_new):
        if path not in paged_paths:
            if path.endswith("['length']"):
                new_len = torch.as_tensor(pos0_h + valid_h, dtype=pool.dtype,
                                          device=dev)
                return torch.where(active_t, new_len, pool)
            # resident per-slot state: keep old rows for inactive slots
            if view_new.dim() >= 2 and view_new.shape[1] == b:
                m = active_t.reshape((1, b) + (1,) * (view_new.dim() - 2))
            else:
                m = active_t.reshape((b,) + (1,) * (view_new.dim() - 1))
            return torch.where(m, view_new, pool)
        s, p, blk_t, off = rows_t
        pool[:, blk_t, off] = view_new[:, s, p]
        return pool

    return tree_map_with_path(scatter, state, new_view)


def _reset_resident(paged_paths: FrozenSet[str], state: Dict,
                    fresh: Dict[str, torch.Tensor], mask) -> Dict:
    """Resident leaves (``length``, recurrent states) re-initialised from
    ``fresh`` on the slots where ``mask`` is set; paged leaves pass
    through."""
    mask = torch.as_tensor(mask, dtype=torch.bool,
                           device=state["length"].device)
    b = mask.shape[0]

    def sel(path, old):
        if path in paged_paths:
            return old
        if old.dim() >= 2 and old.shape[1] == b:
            m = mask.reshape((1, b) + (1,) * (old.dim() - 2))
        else:
            m = mask.reshape((b,) + (1,) * (old.dim() - 1))
        return torch.where(m, fresh[path], old)

    return tree_map_with_path(sel, state)
