"""Rank the ExchangeConfig space, refine the head with measured trials,
and cache the winner as a versioned JSON artifact
(``repro.tuning.search``).

Flow (``launch/tune.py``, then ``launch/train.py --tuned``):

  1. ``space.enumerate_space`` gives the candidates for (tree, P);
  2. analytic rank: ``cost.predict_comm_us`` of each candidate's plan;
     candidates that tie (overlap moves no extra bytes) are split by a
     fixed overlap preference, backward > staged > fused, since hiding
     the same bytes earlier never loses, then by the reference's label;
  3. optional refinement: the analytic top-k is timed end to end in the
     live ``torch.distributed`` world (short trials, round-robin) and
     the winner is the least measured median, the max over the ranks;
  4. the winner goes to ``<cache_dir>/<key>.json``, keyed by the
     STRUCTURAL tree fingerprint (sparse row counts set to 0, so one
     tuned config covers every batch size of the model), the worker
     count and the profile's name.  ``train.py --tuned`` resolves the
     same key at start-up and builds the config with no search.

The key and the artifact's format are the reference's: an artifact the
reference's ``dryrun --tune`` wrote resolves here (its backend ``"jax"``
reads as ``"flat"``).  The port's default cache directory is its own,
``experiments/tuning_torch``, because the reference's loader would
reject an artifact naming ``"flat"`` with an error it does not catch.

Artifacts are versioned: a loader that finds another ``ARTIFACT_VERSION``
rejects the file (``TuningArtifactError``), so a stale cache never
configures a newer exchange.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Union

import torch

from repro_torch.core import exchange as exchange_lib
from repro_torch.core.exchange import ExchangeConfig
from repro_torch.tuning import cost as cost_lib
from repro_torch.tuning import space as space_lib
from repro_torch.tuning.profile import BandwidthProfile, get_profile

ARTIFACT_VERSION = 1
DEFAULT_CACHE_DIR = os.path.join("experiments", "tuning_torch")

#: fixed tie-break among equal predictions: hiding the same wire behind
#: compute earlier in the step never loses
_OVERLAP_PREFERENCE = {False: 2, "staged": 1, "backward": 0}

#: ExchangeConfig fields an artifact holds (after normalisation: the
#: deprecated spellings are always None/False once built)
_CONFIG_FIELDS = ("algorithm", "sparse_as_dense", "fusion_threshold",
                  "reduce_scatter", "codec", "backend",
                  "hierarchy_levels", "use_kernel", "overlap")

#: the reference's backend names in an artifact, read as the port's
_BACKEND_FROM_REFERENCE = {ref: port for port, ref
                           in space_lib.REFERENCE_BACKEND_NAMES.items()}


class TuningArtifactError(RuntimeError):
    """Missing, stale-version, or malformed tuning artifact."""


def config_to_dict(cfg: ExchangeConfig) -> Dict[str, Any]:
    return {f: getattr(cfg, f) for f in _CONFIG_FIELDS}


def config_from_dict(d: Dict[str, Any]) -> ExchangeConfig:
    unknown = set(d) - set(_CONFIG_FIELDS)
    if unknown:
        raise TuningArtifactError(
            f"artifact config has unknown fields {sorted(unknown)}")
    d = dict(d)
    if "backend" in d:
        d["backend"] = _BACKEND_FROM_REFERENCE.get(d["backend"],
                                                   d["backend"])
    return ExchangeConfig(**d)


def artifact_key(grads, n_workers: int,
                 profile: Union[str, BandwidthProfile]) -> str:
    """Stable cache key: the structural tree fingerprint (shapes and
    dtypes, sparse row counts set to 0), the worker count and the
    profile's name."""
    fp = exchange_lib.fingerprint(grads, exact=False)
    name = get_profile(profile).name
    payload = f"tune1|{fp}|P{int(n_workers)}|{name}"
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def artifact_path(cache_dir: str, key: str) -> str:
    return os.path.join(cache_dir, f"{key}.json")


# ---------------------------------------------------------------------------
# Analytic ranking
# ---------------------------------------------------------------------------

def rank_candidates(candidates: List[space_lib.Candidate], grads,
                    profile: Union[str, BandwidthProfile]
                    ) -> List[space_lib.Candidate]:
    """Score every candidate with the cost model and sort ascending
    (cheapest predicted first, the overlap preference as the tie-break).

    The last key is the label the reference gives the config
    (``space.reference_label``: ``jax`` where the port says ``flat``), so
    candidates whose predictions tie exactly (a uniform profile's flat
    and hierarchical plans, say) fall in the reference's order: ``flat``
    sorts before ``hierarchical`` and ``jax`` after it."""
    prof = get_profile(profile)
    for c in candidates:
        plan = exchange_lib.compile_plan(grads, c.config)
        c.predicted_us = cost_lib.predict_comm_us(plan, c.levels, prof)
    candidates.sort(key=lambda c: (
        c.predicted_us, _OVERLAP_PREFERENCE.get(c.config.overlap, 3),
        space_lib.reference_label(c.config)))
    return candidates


# ---------------------------------------------------------------------------
# Measured refinement (inside a torch.distributed world of n_workers)
# ---------------------------------------------------------------------------

def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_candidates(candidates: Sequence[space_lib.Candidate],
                       grads, n_workers: int, *, trials: int = 3,
                       model=None, params=None, batch=None
                       ) -> List[space_lib.Candidate]:
    """Time each candidate's exchange in the live world.

    Every rank of a ``torch.distributed`` world of ``n_workers`` ranks
    (gloo on the CPU, NCCL on the card) calls this with the same
    candidates.  Flat candidates exchange over the world, hierarchical
    ones over the launcher's pods (``launch.train.pod_groups``).  With
    ``model``/``params``/``batch`` a trial is end to end, as the
    launcher's step: ``grad_contributions`` then ``opt.exchange``, or
    ``wait_free_grad_exchange`` under ``overlap="backward"``, so overlap
    modes really differ; without them it times the exchange of
    ``grads`` alone.  Every candidate runs with ``use_kernel=True``, the
    launcher's rule (the candidate's config keeps its own value).

    Each candidate runs twice untimed, then all are timed round-robin
    ``trials`` times.  A rank's per-candidate median is reduced across
    the ranks (the max), so every rank holds the same ``measured_us`` and
    picks the same winner.  A candidate that raises on any rank gets
    ``inf`` and ``error`` and is not timed."""
    import torch.distributed as dist
    from repro_torch.core import DistributedOptimizer
    from repro_torch.optim import adamw

    if not dist.is_initialized():
        raise RuntimeError("measure_candidates runs inside a "
                           "torch.distributed world of n_workers ranks")
    if dist.get_world_size() != n_workers:
        raise ValueError(f"measure_candidates: the world has "
                         f"{dist.get_world_size()} ranks, the search "
                         f"{n_workers} workers")
    device = (params["embedding"].device if model is not None
              else exchange_lib.state_device(None, grads))
    pods = None
    fns: Dict[int, Any] = {}
    failed = torch.zeros(len(candidates), dtype=torch.float64)
    for idx, cand in enumerate(candidates):
        try:
            cfg = dataclasses.replace(cand.config, use_kernel=True)
            group = dist.group.WORLD
            if cfg.is_hierarchical:
                if pods is None:
                    from repro_torch.launch.train import pod_groups
                    pods = pod_groups(dist.get_rank(), n_workers)
                group = pods
            opt = DistributedOptimizer(adamw(1e-3), exchange=cfg,
                                       group=group)
            state0 = (opt.init_exchange_state(grads, device=device)
                      if cfg.codec_obj.stateful else None)
            fn = _trial_fn(opt, grads, state0, model, params, batch)
            fn()                                    # first call
            fn()                                    # warm
            _sync(device)
            fns[idx] = fn
        except Exception as e:                      # pruned at run time
            failed[idx] = 1.0
            cand.error = f"{type(e).__name__}: {e}"[:200]
    flags = failed.to(device)
    dist.all_reduce(flags, op=dist.ReduceOp.MAX)
    for idx, bad in enumerate(flags.cpu().tolist()):
        if bad:
            candidates[idx].measured_us = float("inf")
            candidates[idx].error = (candidates[idx].error
                                     or "failed on another rank")
            fns.pop(idx, None)

    samples: Dict[int, List[float]] = {i: [] for i in fns}
    for _ in range(max(trials, 1)):
        for idx, fn in fns.items():
            _sync(device)
            t0 = time.perf_counter()
            fn()
            _sync(device)
            samples[idx].append(time.perf_counter() - t0)
    if samples:
        ids = sorted(samples)
        medians = torch.tensor([sorted(samples[i])[len(samples[i]) // 2]
                                * 1e6 for i in ids], dtype=torch.float64,
                               device=device)
        dist.all_reduce(medians, op=dist.ReduceOp.MAX)
        for i, us in zip(ids, medians.cpu().tolist()):
            candidates[i].measured_us = us
    return list(candidates)


def _trial_fn(opt, grads, state0, model, params, batch):
    """One trial of a candidate: the exchange of ``grads``, or with a
    model the launcher's gradient step up to the exchanged tree."""
    if model is None:
        return lambda: opt.exchange(grads, state=state0)
    if opt.exchange_config.overlap_backward:
        from repro_torch.training.gradients import wait_free_grad_exchange
        return lambda: wait_free_grad_exchange(
            model, opt, params, batch, state=state0, sparse_embedding=True)
    from repro_torch.training.gradients import grad_contributions

    def fn():
        g = grad_contributions(model, params, batch,
                               sparse_embedding=True)[0]
        return opt.exchange(g, state=state0)
    return fn


# ---------------------------------------------------------------------------
# End-to-end search
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TuningResult:
    key: str
    profile: str
    n_workers: int
    tree_fingerprint: str
    candidates: List[space_lib.Candidate]    # analytic rank order
    winner: space_lib.Candidate
    trials: int

    def table(self) -> str:
        """The ranked markdown table ``launch/tune.py`` prints."""
        lines = ["| rank | config | predicted_us | measured_us |",
                 "|---|---|---|---|"]
        for r, c in enumerate(self.candidates, 1):
            meas = (f"{c.measured_us:.1f}" if c.measured_us is not None
                    else "-")
            star = " *" if c is self.winner else ""
            lines.append(f"| {r} | {c.label}{star} | "
                         f"{c.predicted_us:.1f} | {meas} |")
        return "\n".join(lines)


def search(grads, n_workers: int, *,
           profile: Union[str, BandwidthProfile] = "ethernet",
           trials: int = 0, top_k: int = 5,
           model=None, params=None, batch=None,
           **space_kw) -> TuningResult:
    """Enumerate, rank analytically, with ``trials > 0`` time the top-k
    in the live world (``measure_candidates``), and pick the winner."""
    prof = get_profile(profile)
    cands = space_lib.enumerate_space(grads, n_workers, **space_kw)
    if not cands:
        raise ValueError("empty tuning space")
    rank_candidates(cands, grads, prof)
    if trials > 0:
        head = cands[:min(top_k, len(cands))]
        measure_candidates(head, grads, n_workers, trials=trials,
                           model=model, params=params, batch=batch)
        winner = min(head, key=lambda c: c.measured_us)
    else:
        winner = cands[0]
    return TuningResult(
        key=artifact_key(grads, n_workers, prof),
        profile=prof.name, n_workers=n_workers,
        tree_fingerprint=exchange_lib.fingerprint(grads, exact=False),
        candidates=cands, winner=winner, trials=trials)


# ---------------------------------------------------------------------------
# Artifact I/O
# ---------------------------------------------------------------------------

def save_artifact(result: TuningResult,
                  cache_dir: str = DEFAULT_CACHE_DIR) -> str:
    os.makedirs(cache_dir, exist_ok=True)
    path = artifact_path(cache_dir, result.key)
    doc = {
        "version": ARTIFACT_VERSION,
        "key": result.key,
        "tree_fingerprint": result.tree_fingerprint,
        "n_workers": result.n_workers,
        "profile": result.profile,
        "trials": result.trials,
        "winner": config_to_dict(result.winner.config),
        "winner_label": result.winner.label,
        "ranking": [
            {"config": config_to_dict(c.config), "label": c.label,
             "predicted_us": c.predicted_us,
             "measured_us": c.measured_us, "error": c.error}
            for c in result.candidates],
    }
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
    return path


def load_artifact(path: str) -> Dict[str, Any]:
    """Load and validate one artifact file.  Raises TuningArtifactError
    on a missing file, another version, or a missing winner."""
    if not os.path.exists(path):
        raise TuningArtifactError(f"no tuning artifact at {path}")
    with open(path) as f:
        doc = json.load(f)
    v = doc.get("version")
    if v != ARTIFACT_VERSION:
        raise TuningArtifactError(
            f"stale tuning artifact {path}: version {v!r} != "
            f"{ARTIFACT_VERSION} (re-run launch/tune.py)")
    if "winner" not in doc:
        raise TuningArtifactError(f"malformed tuning artifact {path}: "
                                  f"no winner entry")
    return doc


def load_tuned_config(grads, n_workers: int,
                      profile: Union[str, BandwidthProfile],
                      cache_dir: str = DEFAULT_CACHE_DIR
                      ) -> Optional[Dict[str, Any]]:
    """Resolve the cached artifact for this (tree, P, profile) key.
    Returns the artifact's dict with its winner built into an
    ``ExchangeConfig`` under ``"exchange_config"`` and its ``"path"``, or
    None when no valid artifact exists: callers fall back to an analytic
    search."""
    key = artifact_key(grads, n_workers, profile)
    path = artifact_path(cache_dir, key)
    try:
        doc = load_artifact(path)
    except TuningArtifactError:
        return None
    doc["exchange_config"] = config_from_dict(doc["winner"])
    doc["path"] = path
    return doc
