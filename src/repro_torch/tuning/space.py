"""Enumerate the valid ExchangeConfig space for a (gradient tree, world)
(``repro.tuning.space``).

The space is accumulation algorithm x codec x backend x layout
(reduce-scatter, zero1) x overlap mode x bucket size, crossed and then
pruned to the combinations that are legal on the given world:

  * the hierarchical backend (and so the per-hop requantize) needs a
    two-level fold of an even world of at least 4; it is pruned
    elsewhere;
  * ringsim is a simulation backend and stays out of the default
    deployment space (pass ``backends=`` to include it);
  * reduce-scatter and zero1 need a non-hierarchical backend, and
    reduce-scatter a linear, stateless codec: every candidate builds a
    real ``ExchangeConfig`` and whatever its constructor rejects is
    dropped, so the two rule sets cannot drift;
  * the sparse-gather algorithm axis is enumerated only when the tree
    has sparse contributions.

``mesh_levels(n_workers, hierarchical)`` is the launchers' fold: flat
candidates span ``(P,)``, hierarchical ones ``(2, P // 2)``, the pods of
``launch.train.pod_groups``.

The port's deployment backend is ``"flat"``, the reference's ``"jax"``;
everything else is the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

from repro_torch.core import codecs as codecs_lib
from repro_torch.core.backend import DEFAULT_BACKEND
from repro_torch.core.exchange import ExchangeConfig, SparseSpec, compile_plan
from repro_torch.core.fusion import DEFAULT_FUSION_THRESHOLD

#: codec shortlist of the default space: the identity baseline, the
#: half-width cast, and the quantised wire with and without error
#: feedback (every registered codec stays reachable through ``codecs=``)
DEFAULT_CODECS = ("identity", "bf16", "int8", "int8+ef")
DEFAULT_OVERLAPS = (False, "staged", "backward")
DEFAULT_THRESHOLDS = (None, DEFAULT_FUSION_THRESHOLD)

#: backend names as the reference spells them, where they differ
REFERENCE_BACKEND_NAMES = {"flat": "jax"}


@dataclasses.dataclass
class Candidate:
    """One point of the space, with its scores once filled in."""
    config: ExchangeConfig
    levels: Tuple[int, ...]              # the world fold it runs on
    predicted_us: Optional[float] = None
    measured_us: Optional[float] = None
    error: Optional[str] = None

    @property
    def label(self) -> str:
        return describe_config(self.config)


def describe_config(cfg: ExchangeConfig) -> str:
    """Compact one-cell summary for ranked tables."""
    return _describe(cfg, cfg.backend)


def reference_label(cfg: ExchangeConfig) -> str:
    """``describe_config`` with the reference's backend names: the label
    the reference gives the same config (its rank order's tie-break)."""
    return _describe(cfg, REFERENCE_BACKEND_NAMES.get(cfg.backend,
                                                      cfg.backend))


def _describe(cfg: ExchangeConfig, backend: str) -> str:
    parts = ["dense" if cfg.sparse_as_dense else "gather", cfg.codec,
             backend]
    if cfg.reduce_scatter:
        parts.append("rs")
    if cfg.zero1:
        parts.append("zero1" if cfg.param_codec == "identity"
                     else f"zero1:{cfg.param_codec}")
    parts.append(f"ov={cfg.overlap or 'off'}")
    if cfg.fusion_threshold is not None:
        parts.append(f"thr={cfg.fusion_threshold // (1024 * 1024)}MiB")
    return "/".join(parts)


def mesh_levels(n_workers: int, hierarchical: bool) -> Tuple[int, ...]:
    """The launchers' world fold: hierarchical exchanges span
    ``(2, P // 2)`` (pods, data), flat ones ``(P,)``."""
    if hierarchical:
        return (2, n_workers // 2)
    return (n_workers,)


def _tree_has_sparse(grads) -> bool:
    probe = compile_plan(grads, ExchangeConfig(algorithm="tf_algorithm1"))
    return any(isinstance(c, SparseSpec)
               for contribs in probe.contrib_specs for c in contribs)


def enumerate_space(grads, n_workers: int, *,
                    codecs: Sequence[str] = DEFAULT_CODECS,
                    backends: Optional[Sequence[str]] = None,
                    overlaps: Sequence[Union[bool, str]] = DEFAULT_OVERLAPS,
                    thresholds: Sequence[Optional[int]] = DEFAULT_THRESHOLDS,
                    include_sparse_gather: Optional[bool] = None,
                    include_reduce_scatter: bool = True,
                    include_zero1: bool = True) -> List[Candidate]:
    """Every valid candidate for this gradient tree on ``n_workers``.

    ``backends=None`` enumerates ``flat`` and, on an even world of at
    least 4, ``hierarchical``: the deployment backends.  Pass a list to
    include ``ringsim``.  ``grads`` may hold ``meta`` tensors."""
    if backends is None:
        backends = [DEFAULT_BACKEND]
        if n_workers >= 4 and n_workers % 2 == 0:
            backends.append("hierarchical")
    codecs = [codecs_lib.get_codec(c).name for c in codecs]

    if include_sparse_gather is None:
        include_sparse_gather = _tree_has_sparse(grads)
    accum = [True, False] if include_sparse_gather else [True]

    out: List[Candidate] = []
    for sparse_as_dense in accum:
        for codec in codecs:
            for backend in backends:
                if backend == "hierarchical" and (
                        n_workers < 4 or n_workers % 2):
                    continue                 # per-hop needs a real fold
                # reduce-scatter and zero1 are exclusive layouts of the
                # same RS + AG wire; zero1 also shards the optimizer
                # state, so it is an axis value of its own
                layouts = [(False, False)]
                if include_reduce_scatter and backend != "hierarchical":
                    layouts.append((True, False))
                if include_zero1 and backend != "hierarchical":
                    layouts.append((False, True))
                for rs, z1 in layouts:
                    for overlap in overlaps:
                        for thr in thresholds:
                            try:
                                cfg = ExchangeConfig(
                                    sparse_as_dense=sparse_as_dense,
                                    fusion_threshold=thr,
                                    reduce_scatter=rs, zero1=z1,
                                    codec=codec, backend=backend,
                                    overlap=overlap)
                            except ValueError:
                                continue     # illegal combination
                            out.append(Candidate(
                                config=cfg,
                                levels=mesh_levels(
                                    n_workers,
                                    backend == "hierarchical")))
    return out
