"""Process-global telemetry hook points (``repro.telemetry.hooks``).

This module is the leaf of the telemetry package: it is stdlib-only (no
torch, no other port module), so the hot-path modules (``core.comm``,
``core.backend``, ``core.exchange``) import it unconditionally without
import cycles and without pulling tracing machinery into the default
path.

Design contract, zero overhead when disabled:

* ``wire_recorder()`` / ``tracer()`` return ``None`` unless something
  was explicitly installed.  Every call site gates on that before doing
  any work, so the disabled path costs one global read and one
  ``is None`` check per call site (the port runs eagerly, so per step,
  not once per trace as in the reference); ``tap`` then returns its
  argument itself.
* Recorders are installed around a single measured run
  (``telemetry.trace.measure_wire``) or a single traced step
  (``telemetry.trace.StepTracer.run``), never left active across
  ordinary training.
"""
from __future__ import annotations

import threading

__all__ = [
    "WireRecorder", "wire_recorder", "install_wire_recorder",
    "clear_wire_recorder", "tracer", "install_tracer", "clear_tracer",
    "stage_scope", "current_stage", "record_collective", "tap",
    "UNATTRIBUTED", "flop_counter", "push_flop_counter",
    "pop_flop_counter", "record_work",
]

UNATTRIBUTED = "unattributed"

# Telemetry state is intentionally process-global (not thread-local): the
# wait-free exchange launches its stages from autograd hooks, which run on
# autograd's device thread, and a thread-local recorder or stage stack
# would miss them.  A lock guards install / clear; reads are plain
# (benign under CPython).
_LOCK = threading.Lock()
_WIRE = None
_TRACER = None
_STAGE: list[str] = []
_FLOPS: list = []           # active FLOP counters (launch.flops), innermost last


class WireRecorder:
    """Accumulates per-stage collective counts and wire bytes.

    Populated by ``record_collective`` calls from ``core.comm`` /
    ``core.backend`` while the recorder is installed.  Bytes use the same
    per-hop formulas as the plan's static accounting, so for an exact
    backend and codec the recorded totals equal
    ``ExchangePlan.stage_wire_bytes`` exactly.
    """

    def __init__(self) -> None:
        self.per_stage: dict[str, dict] = {}

    def record(self, kind: str, nbytes: float, stage: str | None) -> None:
        key = stage if stage is not None else UNATTRIBUTED
        row = self.per_stage.setdefault(
            key, {"wire_bytes": 0.0, "collectives": 0, "by_kind": {}})
        row["wire_bytes"] += float(nbytes)
        row["collectives"] += 1
        row["by_kind"][kind] = row["by_kind"].get(kind, 0) + 1

    def stage_wire_bytes(self) -> dict[str, float]:
        return {k: v["wire_bytes"] for k, v in self.per_stage.items()}

    def total_wire_bytes(self) -> float:
        return sum(v["wire_bytes"] for v in self.per_stage.values())

    def total_collectives(self) -> int:
        return sum(v["collectives"] for v in self.per_stage.values())

    def as_dict(self) -> dict:
        return {
            "per_stage": {k: dict(v, by_kind=dict(v["by_kind"]))
                          for k, v in self.per_stage.items()},
            "total_wire_bytes": self.total_wire_bytes(),
            "total_collectives": self.total_collectives(),
        }


def wire_recorder():
    """The installed WireRecorder, or None (the default)."""
    return _WIRE


def install_wire_recorder(rec: WireRecorder) -> None:
    global _WIRE
    with _LOCK:
        if _WIRE is not None:
            raise RuntimeError("a WireRecorder is already installed")
        _WIRE = rec


def clear_wire_recorder() -> None:
    global _WIRE
    with _LOCK:
        _WIRE = None


def tracer():
    """The installed StepTracer (telemetry.trace), or None."""
    return _TRACER


def install_tracer(t) -> None:
    global _TRACER
    with _LOCK:
        if _TRACER is not None:
            raise RuntimeError("a tracer is already installed")
        _TRACER = t


def clear_tracer() -> None:
    global _TRACER
    with _LOCK:
        _TRACER = None


class stage_scope:
    """Attribute nested ``record_collective`` / ``tap`` calls to a stage
    (a context manager).

    Cheap when telemetry is off: an append and a pop on a plain list.  A
    class rather than the reference's generator, because the eager
    exchange enters one for every stage on every step."""

    __slots__ = ("label",)

    def __init__(self, label: str) -> None:
        self.label = label

    def __enter__(self) -> None:
        _STAGE.append(self.label)

    def __exit__(self, *exc) -> bool:
        _STAGE.pop()
        return False


def current_stage() -> str | None:
    return _STAGE[-1] if _STAGE else None


def record_collective(kind: str, nbytes: float) -> None:
    """Bill one collective to the current stage.

    Callers gate on ``wire_recorder() is not None`` before computing
    ``nbytes``; calling this unconditionally is also safe (a no-op when
    nothing is installed)."""
    rec = _WIRE
    if rec is not None:
        rec.record(kind, nbytes, current_stage())


def tap(phase: str, value):
    """Phase-boundary marker.

    When a tracer is installed it records the phase's end (see
    ``telemetry.trace.StepTracer.tap``) and returns ``value``; otherwise
    it returns ``value`` itself and does nothing else."""
    t = _TRACER
    if t is None:
        return value
    return t.tap(phase, current_stage(), value)


# ---------------------------------------------------------------------------
# FLOP counters (``repro_torch.launch.flops``)
# ---------------------------------------------------------------------------

def flop_counter():
    """The innermost active FLOP counter, or None (the default).  A kernel
    wrapper reads this once a launch and bills its work only when it is
    set."""
    return _FLOPS[-1] if _FLOPS else None


def push_flop_counter(counter) -> None:
    with _LOCK:
        _FLOPS.append(counter)


def pop_flop_counter(counter) -> None:
    with _LOCK:
        if not _FLOPS or _FLOPS[-1] is not counter:
            raise RuntimeError("FLOP counters must exit innermost first")
        _FLOPS.pop()


def record_work(flops: float, nbytes: float,
                product_flops: float = 0.0) -> None:
    """Bill work the dispatcher cannot see (a kernel's launch) to the
    active FLOP counter; a no-op when none is active."""
    c = _FLOPS[-1] if _FLOPS else None
    if c is not None:
        c.add(flops, nbytes, product_flops)
