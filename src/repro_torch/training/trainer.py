"""Trainer: the end-to-end loop (data -> step -> metrics -> checkpoint),
the ``repro.training.trainer`` loop without a recorder.

A step whose metrics carry ``overflow`` (a loss-scaled step that skipped
its update) is counted; the flags stay on the device until a log line
reads them, so the loop adds no per-step wait.  Every
``checkpoint_every`` steps ``(params, opt_state, exchange_state)`` is
saved through ``checkpoint`` (a ``ShardedCheckpoint``: the reference's
file, the global view of the ranks' slices); ``resume`` restores the
latest one and continues from its step."""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import ShardedCheckpoint, latest_step


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 0           # 0 disables
    checkpoint_dir: Optional[str] = None
    resume: bool = False


@dataclasses.dataclass
class Trainer:
    model: Any
    step_fn: Callable                   # (params, opt_state, ex_state,
    #                                     batch) -> ...
    pipeline: Any                       # global batches: .batch_at(step)
    config: TrainerConfig
    device: Any                         # where batches go; no default
    rank: int = 0                       # this worker's slice of the batch
    world: int = 1
    checkpoint: Any = None              # ShardedCheckpoint; None: a world
    #                                     of 1 (the local view is global)

    def batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        """This worker's rows of the global batch (the contiguous dim-0
        split the reference's data-parallel mesh makes), on the device."""
        out = {}
        for k, v in self.pipeline.batch_at(step).items():
            rows = v.shape[0] // self.world
            part = np.ascontiguousarray(
                v[self.rank * rows:(self.rank + 1) * rows])
            out[k] = torch.from_numpy(part).to(self.device)
        return out

    def run(self, params, opt_state, exchange_state,
            log: Callable[[str], None] = print) -> Dict[str, Any]:
        """Run the loop.  ``exchange_state`` (an ``ExchangeState`` from
        ``opt.init_exchange_state``) is threaded from step to step and
        returned.  With ``config.resume`` the latest checkpoint in
        ``config.checkpoint_dir`` (if any) replaces the three and the loop
        starts after its step."""
        cfg = self.config
        ckpt = self.checkpoint or ShardedCheckpoint()
        start_step = 0
        if cfg.resume and cfg.checkpoint_dir:
            s = latest_step(cfg.checkpoint_dir)
            if s is not None:
                (params, opt_state, exchange_state), start_step = \
                    ckpt.restore(cfg.checkpoint_dir,
                                 (params, opt_state, exchange_state), step=s)
                log(f"resumed from step {start_step}")
        history: List[Dict[str, float]] = []
        tokens_seen = 0
        overflow_pending: List[torch.Tensor] = []
        overflow_skipped = 0
        t0 = time.perf_counter()
        window_t0, window_steps = t0, 0
        window_data_ms = 0.0
        for step in range(start_step, cfg.total_steps):
            t_fetch = time.perf_counter()
            batch = self.batch_at(step)
            window_data_ms += (time.perf_counter() - t_fetch) * 1e3
            params, opt_state, exchange_state, metrics = self.step_fn(
                params, opt_state, exchange_state, batch)
            if "overflow" in metrics:
                overflow_pending.append(metrics["overflow"])
            tokens_seen += batch["tokens"].numel() * self.world
            window_steps += 1
            if (step + 1) % cfg.log_every == 0 or step == cfg.total_steps - 1:
                # reading the metrics waits for the device, so the window
                # time below covers the steps' device work
                m = {k: float(v) for k, v in metrics.items() if v.dim() == 0}
                now = time.perf_counter()
                if overflow_pending:
                    overflow_skipped += int(sum(
                        int(o) for o in overflow_pending))
                    overflow_pending.clear()
                m.update(step=step + 1, tokens=tokens_seen,
                         tok_per_s=tokens_seen / max(now - t0, 1e-9),
                         step_ms=(now - window_t0) * 1e3
                         / max(window_steps, 1),
                         data_ms=window_data_ms / max(window_steps, 1),
                         overflow_skipped=overflow_skipped)
                window_t0, window_steps = now, 0
                window_data_ms = 0.0
                history.append(m)
                skipped = (f" overflow_skipped={overflow_skipped}"
                           if overflow_skipped else "")
                log(f"step {step+1}: loss={m.get('loss', float('nan')):.4f} "
                    f"ce={m.get('ce', float('nan')):.4f} "
                    f"tok/s={m['tok_per_s']:.0f} "
                    f"step_ms={m['step_ms']:.1f} "
                    f"data_ms={m['data_ms']:.2f}{skipped}")
            if (cfg.checkpoint_every and cfg.checkpoint_dir
                    and (step + 1) % cfg.checkpoint_every == 0):
                ckpt.save(cfg.checkpoint_dir, step + 1,
                          (params, opt_state, exchange_state))
        return {"params": params, "opt_state": opt_state,
                "exchange_state": exchange_state, "history": history}
