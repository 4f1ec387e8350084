"""Step tracing: phase taps, wire measurement, Chrome export
(``repro.telemetry.trace``).

Three tools, all built on the hook points in ``telemetry.hooks``:

* ``measure_wire(fn, *args)`` — run ``fn`` once with a ``WireRecorder``
  installed.  Every collective of ``core/comm.py`` bills its per-worker
  wire bytes (the same per-hop formulas as the plan's static accounting)
  to the enclosing stage scope.  A documented departure from the
  reference, which evaluates ``fn`` abstractly (``jax.eval_shape``, no
  execution): torch has no abstract evaluation through a process group,
  so the port executes ``fn`` once, on copies of its tensor arguments
  (``copy_tensors``), because the exchange updates error-feedback
  residuals and the train step updates params and optimizer state in
  place.  The caller's tensors are bitwise unchanged afterwards.  Every
  rank of the group must call it, as every rank takes part in the
  collectives.

* ``StepTracer`` — taps at the phase boundaries the exchange marks
  (accumulate / pack / collective / unpack).  Off by default: with no
  tracer installed ``hooks.tap`` returns its argument and the step runs
  as it would without telemetry.  On the card each tap records a
  ``torch.cuda.Event`` on the current stream (after the phase's work in
  stream order; the ``collective`` tap after the stage's collectives
  have been waited for) and one synchronisation after the step turns
  the events' elapsed times into seconds on the host clock of the step's
  start, the schema's ``t``: the phase ends are device-ordered, not
  host-enqueue times (the reference's taps are host callbacks).  On the
  CPU each tap reads ``time.perf_counter()``.

* ``chrome_trace(...)`` — convert tap events into Chrome-trace /
  Perfetto JSON: one process per worker, one thread row per schedule
  stage, one duration slice per phase, with the plan's stage names,
  planned and measured wire bytes and the cost model's predicted
  per-stage time in ``otherData``, so ``report`` needs no replay.  The
  dict is the reference's for the same events.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.core.codecs import ExchangeState
from repro_torch.telemetry import hooks

#: phase-end markers in intra-stage order (the trace row anatomy)
PHASES = ("accumulate", "pack", "collective", "unpack")

TRACE_SCHEMA = 1


# ---------------------------------------------------------------------------
# Copies of a step's state
# ---------------------------------------------------------------------------

def copy_tensors(x):
    """``x`` with every tensor cloned (walking dicts, lists, tuples, named
    tuples, dataclasses and ``ExchangeState``), so a run on the copy
    leaves ``x``'s tensors as they were."""
    if isinstance(x, torch.Tensor):
        y = x.detach().clone()
        return y.requires_grad_() if x.requires_grad else y
    if isinstance(x, dict):
        return {k: copy_tensors(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(copy_tensors(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(copy_tensors(v) for v in x)
    if isinstance(x, ExchangeState):
        return ExchangeState(copy_tensors(x.bucket_states))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: copy_tensors(getattr(x, f.name))
            for f in dataclasses.fields(x) if f.init})
    return x


def _on_card(x) -> bool:
    """Whether any tensor in ``x`` (walked as ``copy_tensors`` walks)
    lives on a CUDA device."""
    if isinstance(x, torch.Tensor):
        return x.is_cuda
    if isinstance(x, dict):
        return any(_on_card(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return any(_on_card(v) for v in x)
    if isinstance(x, ExchangeState):
        return _on_card(x.bucket_states)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return any(_on_card(getattr(x, f.name))
                   for f in dataclasses.fields(x))
    return False


def _world() -> tuple:
    """(rank, world size) of the default process group; (0, 1) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


# ---------------------------------------------------------------------------
# Wire measurement (one run on copies; the caller's state untouched)
# ---------------------------------------------------------------------------

def measure_wire(fn: Callable, *args) -> hooks.WireRecorder:
    """Run ``fn`` once on copies of ``args`` with a WireRecorder installed
    and return it.  The collective call sites see the exact buffers the
    exchange moves, so the recorded bytes match the plan's accounting
    formula for formula; the plan's stage scopes attribute every
    collective to its ``plan.stage_name``."""
    rec = hooks.WireRecorder()
    args = copy_tensors(args)
    hooks.install_wire_recorder(rec)
    try:
        fn(*args)
    finally:
        hooks.clear_wire_recorder()
    return rec


# ---------------------------------------------------------------------------
# Phase taps
# ---------------------------------------------------------------------------

class StepTracer:
    """Collects (worker, stage, phase, time) events from the ``hooks.tap``
    sites while installed.  The worker is this process's rank in the
    default process group (0 without one), where the reference computes
    a flat index over its mesh axes."""

    def __init__(self) -> None:
        self.events: List[Dict[str, Any]] = []
        self.step_marks: List[Dict[str, float]] = []
        self._wid = 0
        self._marks: Optional[list] = None    # CUDA events of a step

    # -- called from the exchange (via hooks.tap) ----------------------------
    def tap(self, phase: str, stage: Optional[str], value):
        if self._marks is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._marks.append((stage or "", phase, ev))
        else:
            self.events.append({"stage": str(stage or ""),
                                "phase": str(phase), "worker": self._wid,
                                "t": time.perf_counter()})
        return value

    # -- step boundary markers ----------------------------------------------
    def mark_step(self, t_start: float, t_end: float) -> None:
        self.step_marks.append({"t_start": t_start, "t_end": t_end})

    # -- runs ---------------------------------------------------------------
    def run(self, fn: Callable, *args):
        """One traced call of ``fn(*args)`` on the arguments as given
        (in-place updates land on them); returns its outputs.  On the card
        the device is synchronised before the step, a start event and
        one event per tap are recorded, and one synchronisation after the
        step converts them; the step mark spans start to end on the
        device."""
        self._wid = _world()[0]
        card = _on_card(args)
        hooks.install_tracer(self)
        try:
            if not card:
                t0 = time.perf_counter()
                out = fn(*args)
                self.mark_step(t0, time.perf_counter())
                return out
            torch.cuda.synchronize()
            self._marks = []
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            out = fn(*args)
            end.record()
            torch.cuda.synchronize()
            for stage, phase, ev in self._marks:
                self.events.append({
                    "stage": stage, "phase": phase, "worker": self._wid,
                    "t": t0 + start.elapsed_time(ev) / 1e3})
            self.mark_step(t0, t0 + start.elapsed_time(end) / 1e3)
            return out
        finally:
            self._marks = None
            hooks.clear_tracer()

    def capture(self, fn: Callable, *args, warmup: bool = True):
        """Run ``fn(*args)`` traced: with ``warmup`` a first run whose
        events are discarded, then one timed run that produces the trace.
        Both run on copies of ``args`` (the port's step updates its state
        in place, where the reference's jitted step is functional), so
        the caller's tensors are unchanged.  Returns the timed run's
        outputs."""
        if warmup:
            self.run(fn, *copy_tensors(args))
            self.events.clear()
            self.step_marks.clear()
        return self.run(fn, *copy_tensors(args))


# ---------------------------------------------------------------------------
# Chrome-trace export
# ---------------------------------------------------------------------------

def _phase_rank(phase: str) -> int:
    try:
        return PHASES.index(phase)
    except ValueError:
        return len(PHASES)


def chrome_trace(events: Sequence[Dict[str, Any]],
                 stage_names: Sequence[str],
                 step_marks: Sequence[Dict[str, float]] = (),
                 meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Build a Chrome-trace dict: pid = worker, tid = schedule row (one
    per stage, in schedule order), "X" duration slices per phase.

    Phase events are END markers; each slice spans from the previous
    marker of the same (worker, stage) row — or the step start — to its
    own timestamp."""
    rows = {name: k for k, name in enumerate(stage_names)}
    t_base = min([m["t_start"] for m in step_marks]
                 + [e["t"] for e in events], default=0.0)

    def us(t: float) -> float:
        return (t - t_base) * 1e6

    trace_events: List[Dict[str, Any]] = []
    workers = sorted({e["worker"] for e in events})
    for w in workers:
        for name, row in sorted(rows.items(), key=lambda kv: kv[1]):
            trace_events.append({
                "ph": "M", "name": "thread_name", "pid": w, "tid": row,
                "args": {"name": name}})
        mine = sorted((e for e in events if e["worker"] == w),
                      key=lambda e: (e["t"], _phase_rank(e["phase"])))
        last_by_stage: Dict[str, float] = {}
        step_start = min((m["t_start"] for m in step_marks),
                         default=t_base)
        for e in mine:
            stage = e["stage"]
            row = rows.get(stage)
            if row is None:      # unknown stage (e.g. broadcast rows)
                row = len(rows) + 1
            start = last_by_stage.get(stage, step_start)
            trace_events.append({
                "ph": "X", "name": e["phase"], "cat": "exchange",
                "pid": w, "tid": row,
                "ts": us(start), "dur": max(us(e["t"]) - us(start), 0.0),
                "args": {"stage": stage, "worker": w}})
            last_by_stage[stage] = e["t"]
    for m in step_marks:
        for w in workers or [0]:
            trace_events.append({
                "ph": "X", "name": "step", "cat": "step", "pid": w,
                "tid": len(rows), "ts": us(m["t_start"]),
                "dur": us(m["t_end"]) - us(m["t_start"]), "args": {}})
    other = {"schema": TRACE_SCHEMA, "stage_names": list(stage_names)}
    if meta:
        other.update(meta)
    return {"traceEvents": trace_events, "displayTimeUnit": "ms",
            "otherData": other}


def write_trace(trace: Dict[str, Any], path: str) -> None:
    with open(path, "w") as f:
        json.dump(trace, f, indent=1)


# ---------------------------------------------------------------------------
# One-call capture for an exchange step
# ---------------------------------------------------------------------------

def _gather_ranks(events: List[Dict[str, Any]],
                  marks: List[Dict[str, float]]):
    """Every rank's events, and one step mark spanning the earliest start
    to the latest end, on every rank of the default group (this rank's
    own without one)."""
    rank, world = _world()
    if world == 1:
        return list(events), list(marks)
    parts: List[Any] = [None] * world
    dist.all_gather_object(parts, (events, marks))
    all_events = [e for evs, _ in parts for e in evs]
    all_marks = [m for _, ms in parts for m in ms]
    if not all_marks:
        return all_events, []
    return all_events, [{"t_start": min(m["t_start"] for m in all_marks),
                         "t_end": max(m["t_end"] for m in all_marks)}]


def capture_exchange_trace(plan, fn: Callable, args: tuple, n_workers,
                           profile: str = "ethernet",
                           out_path: Optional[str] = None,
                           extra_meta: Optional[Dict[str, Any]] = None
                           ) -> Dict[str, Any]:
    """Full capture for one exchange-bearing step ``fn(*args)``:

    1. ``measure_wire`` — one run on copies bills the wire bytes per
       stage (against ``plan.stage_wire_bytes``);
    2. ``StepTracer.capture`` — a warm-up, then one timed run on copies
       producing the phase events;
    3. every rank's events gathered over the default process group, and
       the Chrome trace assembled with the plan's names, accounting and
       predicted costs, written to ``out_path`` by rank 0 when given.

    Every rank must call it.  Returns the trace dict (on every rank).
    The reference takes the mesh axis names after ``args``; each rank
    here is its own process and names its worker by its rank."""
    wire = measure_wire(fn, *args)
    tracer = StepTracer()
    tracer.capture(fn, *args)
    events, marks = _gather_ranks(tracer.events, tracer.step_marks)
    meta = plan_trace_meta(plan, n_workers, profile=profile,
                           measured=wire)
    if extra_meta:
        meta.update(extra_meta)
    trace = chrome_trace(events, plan.stage_names(), marks, meta)
    if out_path and _world()[0] == 0:
        write_trace(trace, out_path)
    return trace


def plan_trace_meta(plan, n_workers, profile: str = "ethernet",
                    measured: Optional[hooks.WireRecorder] = None
                    ) -> Dict[str, Any]:
    """Self-contained metadata block for a trace file: stage names, the
    plan's per-stage wire accounting, the cost model's per-stage
    predicted time, and (when given) the wire bytes a ``measure_wire``
    recorder observed: everything ``report`` needs without the plan.
    ``torch_version`` stands where the reference writes ``jax_version``;
    every other key is the reference's."""
    names = plan.stage_names()
    stages = plan.schedule.stages
    planned = {n: int(plan.stage_wire_bytes(s, n_workers))
               for n, s in zip(names, stages)}
    meta: Dict[str, Any] = {
        "n_workers": (list(n_workers)
                      if isinstance(n_workers, (list, tuple))
                      else n_workers),
        "profile": profile,
        "mode": ("backward" if plan.config.overlap_backward
                 else "staged" if plan.config.overlap
                 else "zero1" if plan.config.zero1 else "fused"),
        "codec": plan.config.codec,
        "backend": plan.config.backend,
        "planned_wire_bytes": planned,
        "torch_version": torch.__version__,
    }
    try:
        from repro_torch.tuning import cost as cost_lib
        from repro_torch.tuning import get_profile
        prof = get_profile(profile)
        meta["predicted_us"] = {
            n: float(cost_lib.predict_stage_us(plan, s, n_workers, prof))
            for n, s in zip(names, stages)}
    except Exception as e:   # profile/tuning optional for raw traces
        meta["predicted_us_error"] = str(e)
    if measured is not None:
        meta["measured_wire_bytes"] = {
            k: v for k, v in measured.stage_wire_bytes().items()}
    return meta
