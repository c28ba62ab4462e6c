"""Epoch-boundary batch-size policies.

Policies are HOST-side objects: the global batch size feeds the data pipeline
and selects a compiled train-step bucket, both host decisions. They consume
scalar statistics (already device->host transferred) and return plain ints.

Implemented policies (all from the paper):
  FixedBatch     constant m (the SGD baselines).
  AdaBatch       Devarakonda et al. 2018: multiply m by ``resize_factor``
                 every ``resize_freq`` epochs.
  DiveBatch      m_{k+1} = min(m_max, delta * n * Delta_hat)   [Algorithm 1]
  OracleDiveBatch  same rule, but the caller feeds the *exact* full-dataset
                 diversity (recomputed each epoch) instead of the estimate.

Bucketing: at multi-pod scale an arbitrary integer batch size would (a) not
be divisible by the data-parallel shard count and (b) trigger a fresh XLA
compilation per value. ``bucket()`` snaps m to ``granule * 2^i`` so at most
log2(m_max/granule) compiled variants exist.
"""

from __future__ import annotations

import dataclasses
import math


def bucket(m: int, granule: int, mode: str = "pow2", m_min: int = 1, m_max: int | None = None) -> int:
    """Snap a requested batch size onto the compile-friendly lattice.

    The result is ALWAYS a lattice point (``granule * 2^i`` in pow2 mode, a
    multiple of the granule in "none" mode): an off-lattice ``m_min`` is
    snapped UP to the next lattice point rather than returned verbatim, which
    would silently add a compile bucket beyond the ``num_buckets`` bound.
    When no lattice point exists in ``[m_min, m_max]`` the lattice wins over
    the floor (the largest point <= m_max is returned).
    """
    m = max(int(m), m_min, granule)
    if m_max is not None:
        m = min(m, m_max)
    if mode == "none":
        snapped = max(granule, (m // granule) * granule)
    elif mode == "pow2":
        # nearest power-of-two multiple of the granule (round in log space)
        ratio = max(m / granule, 1.0)
        snapped = granule * (2 ** int(round(math.log2(ratio))))
    else:
        raise ValueError(f"unknown bucket mode {mode!r}")
    floor = max(m_min, granule)
    if snapped < floor:
        if mode == "none":
            snapped = -(-floor // granule) * granule  # ceil to granule multiple
        else:
            while snapped < floor:
                snapped *= 2
    if m_max is not None:
        if mode == "none":
            snapped = min(snapped, (m_max // granule) * granule)
            snapped = max(snapped, granule)
        else:
            while snapped > m_max and snapped > granule:
                snapped //= 2
    return snapped


def num_buckets(m_max: int, granule: int) -> int:
    """Size of the pow2 bucket lattice {granule * 2^i : granule*2^i <= m_max}.

    This is the hard upper bound on distinct compiled step programs any
    adaptive run can trigger (StepEngine caches one program per bucket):
    ``log2(m_max / granule) + 1``.
    """
    return int(math.log2(max(m_max // max(granule, 1), 1))) + 1


@dataclasses.dataclass
class PolicyInfo:
    """Bookkeeping returned by every policy step (logged + checkpointed)."""

    batch_size: int
    raw_batch_size: float
    diversity: float | None = None
    reason: str = ""


class BatchPolicy:
    """Interface: ``on_epoch_end(epoch, diversity) -> PolicyInfo``."""

    def __init__(self, m0: int, m_max: int, granule: int = 1, bucket_mode: str = "pow2"):
        if m0 < 1 or m_max < m0:
            raise ValueError(f"need 1 <= m0 <= m_max, got m0={m0}, m_max={m_max}")
        self.m0 = int(m0)
        self.m_max = int(m_max)
        self.granule = int(granule)
        self.bucket_mode = bucket_mode
        self.m = bucket(m0, granule, bucket_mode, m_max=m_max)

    def on_epoch_end(self, epoch: int, diversity: float | None = None) -> PolicyInfo:
        raise NotImplementedError

    @property
    def max_buckets(self) -> int:
        """Hard upper bound on distinct batch sizes this policy can emit.

        pow2 mode: the lattice size ``log2(m_max/granule) + 1``; "none" mode:
        every multiple of the granule up to m_max. ``bucket()`` outputs are
        always lattice points (an off-lattice ``m_min`` snaps up to the next
        one), so the lattice size IS the bound.
        """
        if self.bucket_mode == "none":
            return max(self.m_max // max(self.granule, 1), 1)
        return num_buckets(self.m_max, self.granule)

    # -- checkpointable state ------------------------------------------------
    def state_dict(self) -> dict:
        return {"m": self.m}

    def load_state_dict(self, state: dict) -> None:
        self.m = int(state["m"])

    @property
    def needs_diversity(self) -> bool:
        return False


class FixedBatch(BatchPolicy):
    def on_epoch_end(self, epoch: int, diversity: float | None = None) -> PolicyInfo:
        return PolicyInfo(self.m, float(self.m), diversity, "fixed")


class AdaBatch(BatchPolicy):
    """Double (by ``resize_factor``) every ``resize_freq`` epochs."""

    def __init__(
        self,
        m0: int,
        m_max: int,
        resize_factor: int = 2,
        resize_freq: int = 20,
        granule: int = 1,
        bucket_mode: str = "pow2",
    ):
        super().__init__(m0, m_max, granule, bucket_mode)
        self.resize_factor = int(resize_factor)
        self.resize_freq = int(resize_freq)

    def on_epoch_end(self, epoch: int, diversity: float | None = None) -> PolicyInfo:
        raw = self.m
        if (epoch + 1) % self.resize_freq == 0:
            raw = self.m * self.resize_factor
        self.m = bucket(raw, self.granule, self.bucket_mode, m_max=self.m_max)
        return PolicyInfo(self.m, float(raw), diversity, "adabatch")


class DiveBatch(BatchPolicy):
    """The paper's Algorithm 1, line 11:  m <- min(m_max, delta * n * Delta).

    ``n`` is the dataset size. ``monotone=True`` optionally forbids shrinking
    (off by default — the paper allows decreases and its nonconvex runs do
    plateau below m_max).
    """

    def __init__(
        self,
        m0: int,
        m_max: int,
        delta: float,
        dataset_size: int,
        granule: int = 1,
        bucket_mode: str = "pow2",
        monotone: bool = False,
        m_min: int | None = None,
    ):
        super().__init__(m0, m_max, granule, bucket_mode)
        self.delta = float(delta)
        self.n = int(dataset_size)
        self.monotone = monotone
        self.m_min = int(m_min) if m_min is not None else 1

    @property
    def needs_diversity(self) -> bool:
        return True

    def on_epoch_end(self, epoch: int, diversity: float | None = None) -> PolicyInfo:
        if diversity is None:
            raise ValueError("DiveBatch.on_epoch_end requires a diversity estimate")
        raw = self.delta * self.n * float(diversity)
        if self.monotone:
            raw = max(raw, self.m)
        m_new = bucket(
            int(max(raw, self.m_min)),
            self.granule,
            self.bucket_mode,
            m_min=self.m_min,
            m_max=self.m_max,
        )
        self.m = m_new
        return PolicyInfo(self.m, raw, float(diversity), self.reason)

    #: provenance tag stamped into every PolicyInfo this rule emits
    reason = "divebatch"


class OracleDiveBatch(DiveBatch):
    """Same resize rule as DiveBatch, but the caller feeds the *exact*
    full-dataset diversity (recomputed at fixed params each epoch — the
    paper's Oracle baseline, ``Trainer(estimator='oracle')``) instead of the
    within-epoch estimate.  Distinguished by ``reason='oracle'`` in the
    PolicyInfo so logs/history tell the two apart."""

    reason = "oracle"


def make_policy(name: str, **kwargs) -> BatchPolicy:
    name = name.lower()
    if name in ("sgd", "fixed"):
        return FixedBatch(kwargs["m0"], kwargs.get("m_max", kwargs["m0"]),
                          kwargs.get("granule", 1), kwargs.get("bucket_mode", "pow2"))
    if name == "adabatch":
        return AdaBatch(
            kwargs["m0"], kwargs["m_max"],
            kwargs.get("resize_factor", 2), kwargs.get("resize_freq", 20),
            kwargs.get("granule", 1), kwargs.get("bucket_mode", "pow2"),
        )
    if name in ("divebatch", "oracle"):
        cls = OracleDiveBatch if name == "oracle" else DiveBatch
        return cls(
            kwargs["m0"], kwargs["m_max"], kwargs["delta"], kwargs["dataset_size"],
            kwargs.get("granule", 1), kwargs.get("bucket_mode", "pow2"),
            kwargs.get("monotone", False), kwargs.get("m_min"),
        )
    raise ValueError(f"unknown policy {name!r}")
