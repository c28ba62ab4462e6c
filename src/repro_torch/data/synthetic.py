"""The paper's synthetic dataset (Section 5.1, eq. 3) plus LM/image
analogues, copied from ``repro/data/synthetic.py`` (numpy only) so that
both packages draw identical data from a seed.

All generators are deterministic functions of a seed, chunk-addressable, and
cheap — so every data-parallel host materialises exactly its own shard, and a
restarted job regenerates identical batches (fault-tolerance requirement).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ArrayDataset:
    """In-memory dataset of parallel arrays (leading axis = samples)."""

    arrays: dict[str, np.ndarray]

    def __len__(self) -> int:
        return len(next(iter(self.arrays.values())))

    def get(self, indices: np.ndarray) -> dict[str, np.ndarray]:
        return {k: v[indices] for k, v in self.arrays.items()}


def sigmoid_synthetic(
    n: int = 20_000, d: int = 512, noise: float = 0.1, seed: int = 0
) -> tuple[ArrayDataset, ArrayDataset, np.ndarray]:
    """y = 1{ sigma(w* . x + eps) > 0.5 },  x ~ U[-1,1]^d,  eps ~ N(0, noise).

    Returns (train 80%, val 20%, w_star) exactly as in the paper.
    """
    rng = np.random.default_rng(seed)
    w_star = rng.standard_normal(d).astype(np.float32)
    x = rng.uniform(-1.0, 1.0, size=(n, d)).astype(np.float32)
    eps = rng.normal(0.0, noise, size=n).astype(np.float32)
    logits = x @ w_star + eps
    prob = 1.0 / (1.0 + np.exp(-logits))
    y = (prob > 0.5).astype(np.int32)
    split = int(n * 0.8)
    train = ArrayDataset({"x": x[:split], "y": y[:split]})
    val = ArrayDataset({"x": x[split:], "y": y[split:]})
    return train, val, w_star


def imagelike_classification(
    n: int = 10_000,
    num_classes: int = 10,
    hw: int = 32,
    channels: int = 3,
    noise: float = 0.35,
    template_rank: int = 6,
    seed: int = 0,
) -> tuple[ArrayDataset, ArrayDataset]:
    """CIFAR-shaped procedural classification task.

    Each class has a low-rank spatial template; a sample is its class template
    mixed with sample-specific low-rank clutter and pixel noise. Low-rank
    structure gives convnets a real (learnable, non-trivial) decision problem,
    so gradient diversity behaves like on natural images: high early, falling
    as the model fits the shared structure.
    """
    rng = np.random.default_rng(seed)
    # class templates: sum of outer products of smooth vectors
    def smooth(k):
        v = rng.standard_normal((k, hw)).astype(np.float32)
        kernel = np.hanning(7).astype(np.float32)
        kernel /= kernel.sum()
        return np.stack([np.convolve(vi, kernel, mode="same") for vi in v])

    templates = np.zeros((num_classes, hw, hw, channels), np.float32)
    for c in range(num_classes):
        for ch in range(channels):
            u, v = smooth(template_rank), smooth(template_rank)
            templates[c, :, :, ch] = (u.T @ v) / np.sqrt(template_rank)

    y = rng.integers(0, num_classes, size=n).astype(np.int32)
    clutter_u, clutter_v = smooth(2), smooth(2)
    x = templates[y]
    mix = rng.standard_normal((n, 1, 1, 1)).astype(np.float32) * 0.15
    x = x + mix * (clutter_u.T @ clutter_v)[None, :, :, None]
    x = x + rng.normal(0.0, noise, size=x.shape).astype(np.float32)
    x = x.astype(np.float32)
    split = int(n * 0.9)
    return (
        ArrayDataset({"x": x[:split], "y": y[:split]}),
        ArrayDataset({"x": x[split:], "y": y[split:]}),
    )



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
