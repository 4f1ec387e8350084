"""Spawning the port's gloo worlds for the multi-process tests.

Every world a test starts goes through ``World`` (or ``spawn_world``,
which also waits for it):

  * its ranks meet on a ``FileStore`` in the world's own output
    directory (``init_method="file://..."``).  No TCP port is chosen,
    released and handed to ranks that bind it seconds later, so no other
    process (the ranks of a world another test runs at the same time
    bind ports as they please) can take the rendezvous in between or
    join it;
  * every rank calls ``join`` for ``init_process_group``, which then
    all-gathers the nonce the parent drew for this world and raises if
    any rank holds another: a rank of a foreign world is named at once;
  * each rank's stdout and stderr go to ``rank<r>.log`` in the output
    directory, and a world that fails (a rank that exits non-zero or is
    still running at the deadline) raises with each such rank's exit
    code and the tail of its log; once one rank has failed, the others
    are killed after ``GRACE`` seconds.

``check_same`` is the workers' consistency check: a digest of results
that must be equal on every rank, compared across the world.
"""
from __future__ import annotations

import hashlib
import os
import secrets
import sys
import time
from dataclasses import dataclass
from multiprocessing import connection as mp_connection
from pathlib import Path
from typing import Callable, Sequence

import torch
import torch.distributed as dist

#: bytes of a failing rank's log quoted in the error
LOG_TAIL = 3000
#: seconds the other ranks get once one rank has failed (they would
#: otherwise wait in a collective for the failed one until the deadline)
GRACE = 10


@dataclass(frozen=True)
class Rendezvous:
    """Where one world's ranks meet, and the nonce that names it."""
    init_method: str
    nonce: int


def new_rendezvous(out_dir) -> Rendezvous:
    """A rendezvous private to one world: a ``FileStore`` file (not yet
    created) in ``out_dir``, named by a fresh 63-bit nonce."""
    nonce = secrets.randbits(63)
    path = Path(out_dir).resolve() / f".world-{nonce:016x}.store"
    return Rendezvous(f"file://{path}", nonce)


def join(rank: int, world: int, rdv: Rendezvous) -> None:
    """``init_process_group`` (gloo) at ``rdv``, then the identity check:
    every rank of the world must hold ``rdv.nonce``."""
    dist.init_process_group("gloo", init_method=rdv.init_method,
                            rank=rank, world_size=world)
    seen = gather_nonces(rdv.nonce)
    if any(n != rdv.nonce for n in seen):
        raise RuntimeError(
            f"rank {rank}: world mix-up at {rdv.init_method}: the ranks "
            f"hold nonces {[hex(n) for n in seen]}, this world's is "
            f"{rdv.nonce:#x}")


def gather_nonces(nonce: int) -> list:
    """Every rank's ``nonce``, in rank order (one allgather over the
    default group)."""
    mine = torch.tensor([nonce], dtype=torch.int64)
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, mine)
    return [int(p) for p in parts]


def _digest(t: torch.Tensor) -> int:
    t = t.detach().contiguous().reshape(-1)
    h = hashlib.sha256(f"{t.dtype}{tuple(t.shape)}".encode())
    h.update(t.view(torch.uint8).numpy().tobytes())
    return int.from_bytes(h.digest()[:8], "little", signed=True)


def check_same(tag: str, tensors: Sequence[torch.Tensor]) -> None:
    """Raise unless every rank of the default group holds bitwise the
    same ``tensors`` (one allgather of their digests, outside the port's
    comm layer and its counters); the error names ``tag`` and the
    positions that differ."""
    if not tensors:
        raise ValueError(f"{tag}: nothing to compare")
    mine = torch.tensor([_digest(t) for t in tensors], dtype=torch.int64)
    parts = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, mine)
    differ = [i for i in range(len(tensors))
              if any(int(p[i]) != int(mine[i]) for p in parts)]
    if differ:
        raise RuntimeError(
            f"{tag}: the ranks disagree on tensors {differ} of "
            f"{len(tensors)} (rank {dist.get_rank()})")


def _rank_main(target: Callable, rank: int, world: int, rdv: Rendezvous,
               out_dir: str) -> None:
    """A spawned rank: its output into ``rank<r>.log``, then ``target``."""
    log = os.open(os.path.join(out_dir, f"rank{rank}.log"),
                  os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    sys.stdout.flush()
    sys.stderr.flush()
    os.dup2(log, 1)
    os.dup2(log, 2)
    os.close(log)
    target(rank, world, rdv, out_dir)


class World:
    """``world`` spawned ranks of ``target(rank, world, rdv, out_dir)``
    (``target`` calls ``join`` first) on a fresh private rendezvous: the
    processes, the output directory and the rendezvous."""

    def __init__(self, target: Callable, world: int, out_dir):
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.rdv = new_rendezvous(self.out_dir)
        self.name = getattr(target, "__name__", str(target))
        ctx = torch.multiprocessing.get_context("spawn")
        self.procs = [ctx.Process(target=_rank_main,
                                  args=(target, r, world, self.rdv,
                                        str(self.out_dir)))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def wait(self, timeout: float = 240) -> None:
        """Wait for every rank, for ``timeout`` seconds at most (one
        deadline for the world; once a rank has failed the others get
        ``GRACE`` seconds more), kill any still running, and raise unless
        each exited 0, with each failing rank's exit code and log tail."""
        deadline = time.monotonic() + timeout
        failed_at = None
        while True:
            alive = [p for p in self.procs if p.is_alive()]
            now = time.monotonic()
            if failed_at is None and any(p.exitcode not in (None, 0)
                                         for p in self.procs):
                failed_at = now
            end = deadline if failed_at is None else min(
                deadline, failed_at + GRACE)
            if not alive or now >= end:
                break
            mp_connection.wait([p.sentinel for p in alive],
                               timeout=min(end - now, 1.0))
        hung = {r for r, p in enumerate(self.procs) if p.is_alive()}
        for r in hung:
            self.procs[r].kill()
            self.procs[r].join()
        bad = [r for r, p in enumerate(self.procs) if p.exitcode != 0]
        if bad:
            why = ("a rank failed" if failed_at is not None
                   else f"{timeout:g} s")
            raise AssertionError(
                f"world {self.name} of {len(self.procs)} failed:\n"
                + "\n".join(self._report(r, r in hung, why) for r in bad))

    def _report(self, rank: int, hung: bool, why: str) -> str:
        what = (f"still running ({why}), killed" if hung
                else f"exit code {self.procs[rank].exitcode}")
        log = self.out_dir / f"rank{rank}.log"
        tail = (log.read_text(errors="replace")[-LOG_TAIL:]
                if log.exists() else "(no log)")
        return f"--- rank {rank}: {what}; log tail:\n{tail}"


def spawn_world(target: Callable, world: int, out_dir,
                timeout: float = 240) -> None:
    """Start a ``World`` and wait for it (see ``World.wait``)."""
    World(target, world, out_dir).wait(timeout)
