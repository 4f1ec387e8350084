"""The port's cost model (``repro_torch.tuning``) against the reference's
(``repro.tuning``):

  * each preset's ``to_dict()`` equal, and a JSON profile read back by
    ``get_profile`` (path) on both sides;
  * ``cost_passes`` equal for every registered codec, with and without
    error feedback;
  * ``predict_stage_us``, ``stage_costs_us`` and ``predict_comm_us``
    equal within relative 1e-12 over the configs of
    tests/test_torch_stage_names.py x n_workers {2, 8, (2, 4)} x the four
    presets (the hierarchical plans refuse a flat count on both sides);
  * ``roofline_terms`` and ``alpha_beta_time_s`` equal.
"""
import json
import math

import pytest

pytest.importorskip("torch")

from repro.core import codecs as jcodecs                       # noqa: E402
from repro.tuning import cost as jcost                         # noqa: E402
from repro.tuning import profile as jprofile                   # noqa: E402
from repro_torch.core import codecs                            # noqa: E402
from repro_torch.tuning import cost, profile                   # noqa: E402

import test_torch_stage_names as S                             # noqa: E402

PRESETS = ("cpu", "ethernet", "ib", "tpu")
LEVELS = (2, 8, (2, 4))


def test_presets_equal_reference():
    assert profile.available_profiles() == jprofile.available_profiles()
    assert profile.available_profiles() == PRESETS
    for name in PRESETS:
        got = profile.get_profile(name)
        assert got.to_dict() == jprofile.get_profile(name).to_dict()
        assert profile.get_profile(got) is got
    with pytest.raises(ValueError, match="unknown bandwidth profile"):
        profile.get_profile("h100")


def test_json_profile_round_trips(tmp_path):
    d = dict(profile.PROFILES["ib"].to_dict(), name="custom",
             cross_bw=3.5e9)
    path = tmp_path / "custom.json"
    path.write_text(json.dumps(d))
    got = profile.get_profile(str(path))
    assert got.to_dict() == d
    assert got.to_dict() == jprofile.get_profile(str(path)).to_dict()
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"name": "x", "speed": 1}))
    with pytest.raises(ValueError, match="unknown BandwidthProfile"):
        profile.get_profile(str(bad))


def test_level_constants_equal_reference():
    for name in PRESETS:
        p, j = profile.get_profile(name), jprofile.get_profile(name)
        for n in (1, 2, 3):
            for k in range(n):
                assert p.level_bandwidth(k, n) == j.level_bandwidth(k, n)
                assert p.level_alpha(k, n) == j.level_alpha(k, n)


@pytest.mark.parametrize("name", codecs.available_codecs())
def test_cost_passes_equal_reference(name):
    for n in (name, name + codecs.EF_SUFFIX):
        if n.count(codecs.EF_SUFFIX) > 1:
            continue
        assert codecs.get_codec(n).cost_passes == \
            jcodecs.get_codec(n).cost_passes, n


def _close(a, b):
    return math.isclose(a, b, rel_tol=1e-12, abs_tol=0.0) or a == b


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("name", sorted(S.CONFIGS))
def test_predictions_equal_reference(name, preset):
    plan, jplan = S.plans(name)
    prof = profile.get_profile(preset)
    for n in LEVELS:
        if S.is_hier(name) and isinstance(n, int):
            with pytest.raises(ValueError):
                cost.predict_comm_us(plan, n, preset)
            with pytest.raises(ValueError):
                jcost.predict_comm_us(jplan, n, preset)
            continue
        for st, jst in zip(plan.schedule.stages, jplan.schedule.stages):
            assert _close(cost.predict_stage_us(plan, st, n, prof),
                          jcost.predict_stage_us(jplan, jst, n, preset))
        got, want = (cost.stage_costs_us(plan, n, preset),
                     jcost.stage_costs_us(jplan, n, preset))
        assert len(got) == len(want) == plan.schedule.n_stages
        assert all(_close(a, b) for a, b in zip(got, want))
        assert _close(cost.predict_comm_us(plan, n, prof),
                      jcost.predict_comm_us(jplan, n, preset))
        assert cost.predict_comm_us(plan, n, preset) > 0


@pytest.mark.parametrize("preset", PRESETS)
def test_roofline_and_alpha_beta_equal_reference(preset):
    for flops, hbm, coll in ((1e12, 2e9, 3e8), (5e9, 0.0, 1.0)):
        assert cost.roofline_terms(flops, hbm, coll, preset) == \
            jcost.roofline_terms(flops, hbm, coll, preset)
    for total, n_coll, p in ((1e9, 16, 8), (123.0, 1, 1), (4e6, 3, 2)):
        assert cost.alpha_beta_time_s(total, n_coll, p, preset) == \
            jcost.alpha_beta_time_s(total, n_coll, p, preset)
