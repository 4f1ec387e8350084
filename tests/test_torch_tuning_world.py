"""Tuning across a gloo world of 4, spawned once
(``_torch_dist_worker.run_tuning``), on the reduced transformer-big:

  * ``search`` with measured trials (top 6 of the default space, 2
    trials, end to end): every candidate that ran has a finite median,
    every rank holds the same medians and picks the same winner, and the
    winner is the least median;
  * ``launch.tune`` (analytic) writes the artifact from rank 0, then
    ``launch.train --tuned --steps 2`` resolves it on every rank with no
    fallback, and trains bitwise as the same config given by flags (the
    losses of both steps and the final parameters); the tuned run's pods
    follow the winner's backend.
"""
import math

import pytest

torch = pytest.importorskip("torch")

import _torch_dist_worker as W                                 # noqa: E402
from _torch_world import spawn_world                           # noqa: E402

WORLD = 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("tuning4")
    spawn_world(W.run_tuning, WORLD, out, timeout=240)
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def test_measured_medians_finite_and_equal_on_every_rank(ranks):
    head = ranks[0]["head"]
    ran = [(label, us) for label, us, err in head if err is None]
    assert len(ran) >= 4
    assert all(math.isfinite(us) and us > 0 for _, us in ran)
    assert all(not math.isfinite(us) for _, us, err in head if err)
    for r in ranks[1:]:
        assert r["head"] == head


def test_every_rank_picks_the_same_winner(ranks):
    winners = {r["winner"] for r in ranks}
    assert len(winners) == 1
    head = ranks[0]["head"]
    assert ranks[0]["winner"] == min(head, key=lambda h: h[1])[0]


def test_tuned_launch_resolves_the_artifact(ranks):
    for r in ranks:
        assert "falling back" not in r["runs"]["tuned"]["stderr"]
        assert r["tune_winner"] == ranks[0]["tune_winner"]
    log = ranks[0]["runs"]["tuned"]["log"]
    assert any(s.startswith(f"tuned exchange: {ranks[0]['tune_winner']} ")
               for s in log)
    if "/hierarchical/" in ranks[0]["tune_winner"]:
        assert any("2x2 pod/data" in s for s in log)


def test_tuned_training_is_bitwise_the_flagged_config(ranks):
    for r in ranks:
        tuned, flags = r["runs"]["tuned"], r["runs"]["flags"]
        assert len(tuned["losses"]) == 2
        assert all(math.isfinite(x) for x in tuned["losses"])
        assert tuned["losses"] == flags["losses"]
        assert len(tuned["params"]) == len(flags["params"])
        for a, b in zip(tuned["params"], flags["params"]):
            assert torch.equal(a, b)
