"""Deterministic synthetic data pipeline, the port's own copy.

A numpy copy of ``repro.data.pipeline``: for the same seed, step and host
it yields bitwise the same batches, so the two packages train on the same
data.  Batches stay numpy; the trainer moves them to the device.

  * ``SyntheticLM`` — Zipf-distributed token streams (the embedding
    gradient's row ids are exactly these tokens, so their skew matters).
  * ``SyntheticTranslation`` — reversible source->target pairs (reverse +
    vocab shift), a learnable stand-in for WMT17 en-de.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    vocab: int
    zipf_a: float = 1.2

    def sample(self, rng: np.random.Generator, batch: int, seq: int
               ) -> Dict[str, np.ndarray]:
        raw = rng.zipf(self.zipf_a, size=(batch, seq + 1))
        toks = np.minimum(raw - 1, self.vocab - 1).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


@dataclasses.dataclass(frozen=True)
class SyntheticTranslation:
    """tokens = [src ; tgt]; loss only on tgt.  ``reverse=False`` is the
    order-preserving "copy" task."""
    vocab: int
    shift: int = 7
    reverse: bool = True

    def sample(self, rng: np.random.Generator, batch: int, seq: int
               ) -> Dict[str, np.ndarray]:
        half = seq // 2
        src = rng.integers(4, self.vocab, size=(batch, half),
                           dtype=np.int32)
        base = src[:, ::-1] if self.reverse else src
        tgt = ((base + self.shift - 4) % (self.vocab - 4) + 4
               ).astype(np.int32)
        toks = np.concatenate([src, tgt], axis=1)
        labels = np.concatenate([toks[:, 1:],
                                 np.zeros((batch, 1), np.int32)], axis=1)
        mask = np.zeros((batch, seq), np.float32)
        mask[:, half - 1:-1] = 1.0
        return {"tokens": toks, "labels": labels, "loss_mask": mask}


@dataclasses.dataclass
class DataPipeline:
    task: object
    batch_per_host: int
    seq_len: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1
    frontend_embeds: int = 0      # audio stub embeddings per sample
    d_model: int = 0

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """Deterministic batch for (step, host) — restart-safe."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.host_id)
        b = self.task.sample(rng, self.batch_per_host, self.seq_len)
        if self.frontend_embeds:
            b["frontend"] = rng.standard_normal(
                (self.batch_per_host, self.frontend_embeds, self.d_model)
            ).astype(np.float32)
        return b


def make_pipeline(cfg, batch_per_host: int, seq_len: int, seed: int = 0,
                  host_id: int = 0, n_hosts: int = 1,
                  task: str = "lm") -> DataPipeline:
    if task == "translation":
        gen = SyntheticTranslation(cfg.vocab)
    elif task == "copy":
        gen = SyntheticTranslation(cfg.vocab, reverse=False)
    else:
        gen = SyntheticLM(cfg.vocab)
    fe = cfg.frontend.n_embeds if cfg.frontend is not None else 0
    return DataPipeline(task=gen, batch_per_host=batch_per_host,
                        seq_len=seq_len, seed=seed, host_id=host_id,
                        n_hosts=n_hosts, frontend_embeds=fe,
                        d_model=cfg.d_model)
