"""The multi-process tests' spawn helper (``tests/_torch_world.py``):

  * two worlds spawned at once each see only their own nonce;
  * a port that another process binds between the choice of a world's
    rendezvous and its ranks' start cannot break the world (the
    rendezvous is a file in the world's own directory, not a TCP port
    found free and released);
  * a rank of another world fails the identity check, naming the mix-up;
  * ``check_same`` raises, naming its tag, when the ranks disagree;
  * a failed world reports each failing rank's exit code and log tail,
    and a rank still running once another has failed is killed after the
    grace period instead of the deadline.
"""
import dataclasses
import socket
import time
import urllib.parse

import pytest

torch = pytest.importorskip("torch")

import _torch_dist_worker as W                                 # noqa: E402
import _torch_world                                             # noqa: E402
from _torch_world import World, spawn_world                      # noqa: E402


def _load(world, rank):
    return torch.load(world.out_dir / f"rank{rank}.pt")


def test_two_worlds_spawned_at_once_each_see_only_their_own_nonce(
        tmp_path):
    worlds = [World(W.run_identity, 2, tmp_path / name)
              for name in ("a", "b")]
    for w in worlds:
        w.wait(timeout=120)
    a, b = worlds
    assert a.rdv.nonce != b.rdv.nonce
    assert a.rdv.init_method != b.rdv.init_method
    for w in worlds:
        for r in range(2):
            res = _load(w, r)
            assert res["nonce"] == w.rdv.nonce
            assert res["seen"] == [w.rdv.nonce] * 2


def test_a_port_taken_before_the_ranks_start_cannot_break_a_world(
        tmp_path, monkeypatch):
    """Whatever TCP port a rendezvous names is bound and listened on by
    another socket before the ranks start, as a gloo rank of a world
    running beside it may bind it: the world still forms."""
    squatters = []
    fresh = _torch_world.new_rendezvous

    def squatted(out_dir):
        rdv = fresh(out_dir)
        url = urllib.parse.urlparse(rdv.init_method)
        if url.port is not None:
            s = socket.socket()
            s.bind((url.hostname, url.port))
            s.listen()
            squatters.append(s)
        return rdv

    monkeypatch.setattr(_torch_world, "new_rendezvous", squatted)
    try:
        w = World(W.run_identity, 2, tmp_path)
        w.wait(timeout=120)
    finally:
        for s in squatters:
            s.close()
    assert [_load(w, r)["seen"] for r in range(2)] == \
        [[w.rdv.nonce] * 2] * 2


def test_a_rank_of_another_world_fails_the_identity_check(tmp_path):
    """Rank 1 meets rank 0 at its rendezvous but holds another world's
    nonce: both ranks raise, naming the mix-up."""
    rdv = _torch_world.new_rendezvous(tmp_path)
    foreign = dataclasses.replace(rdv, nonce=rdv.nonce ^ 1)
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_torch_world._rank_main,
                         args=(W.run_identity, r, 2, x, str(tmp_path)))
             for r, x in enumerate((rdv, foreign))]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
        if p.is_alive():
            p.kill()
            p.join()
    for r, p in enumerate(procs):
        assert p.exitcode != 0
        log = (tmp_path / f"rank{r}.log").read_text()
        assert "world mix-up" in log, log[-2000:]
        assert hex(rdv.nonce) in log and hex(foreign.nonce) in log
    assert not any((tmp_path / f"rank{r}.pt").exists() for r in range(2))


def test_check_same_names_the_results_the_ranks_disagree_on(tmp_path):
    with pytest.raises(AssertionError) as err:
        spawn_world(W.run_disagree, 2, tmp_path, timeout=120)
    msg = str(err.value)
    for r in range(2):
        assert f"rank {r}: exit code 1" in msg
    assert "rank-dependent: the ranks disagree on tensors [0] of 1" in msg


def test_a_failed_world_reports_exit_codes_and_stops_within_its_grace(
        tmp_path, monkeypatch):
    monkeypatch.setattr(_torch_world, "GRACE", 2)
    t0 = time.monotonic()
    with pytest.raises(AssertionError) as err:
        spawn_world(W.run_one_rank_fails, 2, tmp_path, timeout=300)
    assert time.monotonic() - t0 < 120
    msg = str(err.value)
    assert "world run_one_rank_fails of 2 failed" in msg
    assert "rank 1: exit code 1" in msg
    assert "RuntimeError: rank 1 fails on purpose" in msg
    assert "rank 0: still running (a rank failed), killed" in msg
