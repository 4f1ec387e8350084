"""Batched serving engine: prefill + greedy decode over a KV cache
(``repro.serving.engine.ServeEngine``).

``generate`` prefills the prompts through ``Model.prefill`` and then
decodes one token a step through ``Model.decode_step`` for the whole
batch, masking rows that have emitted EOS.  It passes no encoder states,
as the reference's engine does, so its cached self-attention always runs
the plain ``decode_attention`` and it takes no ``attn_impl``.  The
reference's ``params_version`` waits for hot swap.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


def sample_greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)


@dataclasses.dataclass
class ServeEngine:
    model: object
    params: object
    cache_len: int
    window: Optional[int] = None
    ring: bool = False
    eos_id: int = 2

    @torch.no_grad()
    def generate(self, prompts: np.ndarray, max_new: int = 32
                 ) -> np.ndarray:
        """prompts (B, P) int32 -> generated (B, n) int32, n <= max_new.

        Rows that hit EOS are FINISHED: every later position is masked to
        ``eos_id``.  Generation stops once every row has finished."""
        device = self.params["embedding"].device
        tokens = torch.as_tensor(np.asarray(prompts), device=device)
        b = tokens.shape[0]
        cache = self.model.init_cache(b, self.cache_len, device=device)
        logits, cache = self.model.prefill(
            self.params, cache, tokens, window=self.window, ring=self.ring)
        out = []
        tok = sample_greedy(logits)[:, None]
        done = torch.zeros((b,), dtype=torch.bool, device=device)
        eos = torch.tensor(self.eos_id, dtype=torch.int32, device=device)
        for _ in range(max_new):
            out.append(tok[:, 0].cpu().numpy())
            done = done | (tok[:, 0] == self.eos_id)
            if bool(done.all()):
                break
            logits, cache = self.model.decode_step(
                self.params, cache, tok, window=self.window, ring=self.ring)
            # finished rows emit eos_id, not whatever the model sampled
            tok = torch.where(done[:, None], eos,
                              sample_greedy(logits)[:, None])
        return np.stack(out, axis=1)
