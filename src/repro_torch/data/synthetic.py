"""The synthetic LM corpus, copied from ``repro/data/synthetic.py`` so that
both packages draw identical token streams (numpy only).  The paper's
sigmoid and image-like datasets come with the small-model training slice
(ROADMAP.md, Queue A)."""

from __future__ import annotations

import numpy as np


class TokenStream:
    """Deterministic synthetic LM corpus: order-1 Markov chain over a Zipfian
    vocabulary. Chunk-addressable: ``tokens(start, length)`` is a pure function
    of (seed, start), so any host can materialise any window independently.
    """

    def __init__(self, vocab_size: int, seed: int = 0, branch: int = 64):
        self.vocab_size = int(vocab_size)
        self.seed = int(seed)
        self.branch = int(branch)
        rng = np.random.default_rng(seed)
        # per-state successor table (sparse transition structure)
        self._succ = rng.integers(
            0, vocab_size, size=(min(vocab_size, 4096), branch), dtype=np.int64
        )
        zipf = 1.0 / np.arange(1, branch + 1) ** 1.1
        self._probs = (zipf / zipf.sum()).astype(np.float64)

    def tokens(self, start: int, length: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, start))
        out = np.empty(length, np.int32)
        state = int(rng.integers(0, self._succ.shape[0]))
        choices = rng.choice(self.branch, size=length, p=self._probs)
        for i in range(length):
            nxt = int(self._succ[state % self._succ.shape[0], choices[i]])
            out[i] = nxt % self.vocab_size
            state = nxt % self._succ.shape[0]
        return out

    def batch(self, step: int, batch_size: int, seq_len: int) -> dict[str, np.ndarray]:
        """(batch, seq+1) tokens -> {'tokens': (B,S), 'targets': (B,S)}."""
        span = seq_len + 1
        base = step * batch_size * span
        toks = np.stack(
            [self.tokens(base + b * span, span) for b in range(batch_size)]
        )
        return {"tokens": toks[:, :-1].astype(np.int32), "targets": toks[:, 1:].astype(np.int32)}
