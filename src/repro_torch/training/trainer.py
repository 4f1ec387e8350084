"""Trainer: the end-to-end loop (data -> step -> metrics), the
``repro.training.trainer`` loop without checkpoints or a recorder."""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List

import numpy as np
import torch


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    log_every: int = 10


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
        returned."""
        cfg = self.config
        history: List[Dict[str, float]] = []
        tokens_seen = 0
        t0 = time.perf_counter()
        window_t0, window_steps = t0, 0
        window_data_ms = 0.0
        for step in range(cfg.total_steps):
            t_fetch = time.perf_counter()
            batch = self.batch_at(step)
            window_data_ms += (time.perf_counter() - t_fetch) * 1e3
            params, opt_state, exchange_state, metrics = self.step_fn(
                params, opt_state, exchange_state, batch)
            tokens_seen += batch["tokens"].numel() * self.world
            window_steps += 1
            if (step + 1) % cfg.log_every == 0 or step == cfg.total_steps - 1:
                # reading the metrics waits for the device, so the window
                # time below covers the steps' device work
                m = {k: float(v) for k, v in metrics.items() if v.dim() == 0}
                now = time.perf_counter()
                m.update(step=step + 1, tokens=tokens_seen,
                         tok_per_s=tokens_seen / max(now - t0, 1e-9),
                         step_ms=(now - window_t0) * 1e3
                         / max(window_steps, 1),
                         data_ms=window_data_ms / max(window_steps, 1))
                window_t0, window_steps = now, 0
                window_data_ms = 0.0
                history.append(m)
                log(f"step {step+1}: loss={m.get('loss', float('nan')):.4f} "
                    f"ce={m.get('ce', float('nan')):.4f} "
                    f"tok/s={m['tok_per_s']:.0f} "
                    f"step_ms={m['step_ms']:.1f} "
                    f"data_ms={m['data_ms']:.2f}")
        return {"params": params, "opt_state": opt_state,
                "exchange_state": exchange_state, "history": history}
