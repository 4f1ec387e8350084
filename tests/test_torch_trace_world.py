"""Telemetry across a gloo world of 4, spawned once
(``_torch_dist_worker.run_trace``):

  * ``measure_wire``'s per-stage bytes equal ``plan.stage_wire_bytes(
    stage, 4)`` exactly for tests/test_telemetry.py's ``WIRE_CASES``
    (identity, int8, rs-ag, ringsim, staged), for f8e4m3, for two gather
    plans (int8, ringsim), for the hierarchical backend at (2, 2) (the
    sum of ``stage_hop_wire_bytes``), for ZeRO-1 (grad and param halves
    billed to one stage) and for a stateful int8+ef exchange;
  * ``measure_wire`` leaves the caller's grads and state (residuals,
    params, the Zero1State) bitwise unchanged;
  * a traced exchange (``StepTracer.capture``) is bitwise the untraced
    one, and with nothing installed an exchange issues the plan's
    collectives;
  * ``capture_exchange_trace``: the stage set equals ``stage_names()``,
    every stage has all four phases, ``n_workers_traced == 4`` and
    ``wire_exact``.
"""

import pytest

torch = pytest.importorskip("torch")

import _torch_dist_worker as W                                 # noqa: E402
from _torch_world import spawn_world                           # noqa: E402
from repro_torch.telemetry import hooks                        # noqa: E402
from repro_torch.telemetry.trace import PHASES                 # noqa: E402

WORLD = 4
KINDS = {"all-reduce", "reduce-scatter", "all-gather", "collective-permute"}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("trace4")
    spawn_world(W.run_trace, WORLD, out, timeout=240)
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


@pytest.mark.parametrize("name", list(W.TRACE_CASES))
def test_measured_wire_equals_plan(ranks, name):
    for res in ranks:
        r = res[name]
        rec = r["recorded"]["per_stage"]
        assert set(rec) == set(r["planned"]), (set(rec), set(r["planned"]))
        assert hooks.UNATTRIBUTED not in rec
        for stage, want in r["planned"].items():
            assert rec[stage]["wire_bytes"] == want, (stage, rec[stage],
                                                      want)
            assert want == sum(r["planned_hops"][stage])
            assert set(rec[stage]["by_kind"]) <= KINDS
        assert r["recorded"]["total_wire_bytes"] == sum(
            r["planned"].values()) > 0
    kinds = {k for st in ranks[0][name]["recorded"]["per_stage"].values()
             for k in st["by_kind"]}
    if W.TRACE_CASES[name][0] == "ringsim":
        assert kinds == {"collective-permute"}
    if name == "rs-ag":
        assert kinds == {"reduce-scatter", "all-gather"}
    if name == "hierarchical":
        assert kinds == {"all-reduce"}
        # one allreduce per level per stage
        st = next(iter(ranks[0][name]["recorded"]["per_stage"].values()))
        assert st["collectives"] == 2


@pytest.mark.parametrize("name", list(W.TRACE_CASES))
def test_caller_state_unchanged(ranks, name):
    for res in ranks:
        assert res[name]["unchanged"]
        assert res[name]["unchanged_after_all"]
    if "ef" in name:
        assert ranks[0][name]["residuals"] > 0


@pytest.mark.parametrize("name", list(W.TRACE_CASES))
def test_traced_exchange_bitwise_and_untraced_calls(ranks, name):
    for res in ranks:
        r = res[name]
        assert r["traced_bitwise"]
        assert r["hooks_off"]
        issued = sum(v for k, v in r["calls"].items()
                     if k != "two_level_all_reduce")
        assert issued == r["plan_calls"]


@pytest.mark.parametrize("name", list(W.TRACE_CASES))
def test_trace_covers_every_stage(ranks, name):
    for res in ranks:
        t = res[name]["trace"]
        assert t["stages"] == sorted(t["names"])
        for stage in t["names"]:
            assert t["phases"][stage] == sorted(PHASES), stage
        assert t["min_dur"] >= 0
        assert t["n_workers_traced"] == WORLD
        assert t["wire_exact"]
        want = [2, 2] if W.TRACE_CASES[name][0] == "hierarchical" else WORLD
        assert t["n_workers"] == want
