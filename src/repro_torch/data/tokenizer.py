"""Toy BPE-less tokenizer for the synthetic translation task (a verbatim
copy of ``repro.data.tokenizer``: pure Python and numpy).

Maps characters to ids deterministically; enough to exercise the full
pipeline (the paper's WMT17 corpus is not available offline; DESIGN.md
§6 documents this substitution).
"""
from __future__ import annotations

from typing import List

import numpy as np

PAD, BOS, EOS, UNK = 0, 1, 2, 3
SPECIALS = 4


class ToyTokenizer:
    def __init__(self, vocab_size: int = 512):
        self.vocab_size = vocab_size

    def encode(self, text: str, max_len: int) -> np.ndarray:
        ids = [BOS] + [SPECIALS + (ord(c) % (self.vocab_size - SPECIALS))
                       for c in text][: max_len - 2] + [EOS]
        out = np.full((max_len,), PAD, np.int32)
        out[: len(ids)] = ids
        return out

    def decode(self, ids) -> str:
        out = []
        for i in ids:
            if i == EOS:
                break
            if i >= SPECIALS:
                out.append(chr((int(i) - SPECIALS) % 128))
        return "".join(out)
