"""AdaptationProgram — runs an adaptation policy against the training clock.

A copy of ``repro/adapt/program.py`` (pure Python).  One program = one
policy + one :class:`LrCoupling` + the live scalar state (lr, epoch
counter, decision history).  The training loop calls :meth:`observe` at
every boundary — epoch ends, every-``tick_every``-steps ticks, injected
events — and then reads ``batch_size`` / ``lr`` / ``estimator`` back.

Checkpoint schema: ``state_dict`` emits version 2 ``{"version": 2, ...}``;
``load_state_dict`` also accepts the pre-redesign (v1) controller dict
``{"policy": {...}, "lr": ..., "epoch": ..., "history": [...]}`` so
checkpoints written before the redesign restore unchanged.
"""

from __future__ import annotations

import dataclasses

from repro_torch.adapt.combinators import LrCoupling
from repro_torch.adapt.signals import Clock, Signals
from repro_torch.obs import runlog as runlog_lib
from repro_torch.obs import trace as trace_lib

#: checkpoint schema version written by state_dict
SCHEMA_VERSION = 2


@dataclasses.dataclass
class Applied:
    """One decision as actually applied (the program's history record)."""

    epoch: int
    step: int
    boundary: str
    batch_size: int
    lr: float
    diversity: float | None = None
    raw_batch_size: float | None = None
    reason: str = ""
    rescaled: bool = False
    estimator: str | None = None
    rung: int | None = None


class AdaptationProgram:
    """Drive an :class:`AdaptationPolicy` against the training clock.

    tick_every   > 0 asks the Trainer to open a "tick" boundary every that
                 many optimizer steps (0 = epoch boundaries only).
    estimator    the current diversity-estimator tier; a Decision carrying
                 ``estimator=...`` retargets it (the Trainer rebuilds its
                 compiled step accordingly).
    """

    def __init__(
        self,
        policy,
        base_lr: float,
        coupling: LrCoupling | None = None,
        *,
        estimator: str = "moment",
        tick_every: int = 0,
    ):
        self.policy = policy
        self.coupling = coupling if coupling is not None else LrCoupling()
        self.lr = float(base_lr)
        self.base_lr = float(base_lr)
        self.estimator = estimator
        self.tick_every = int(tick_every)
        self.epoch = 0
        self.history: list[Applied] = []
        # telemetry sinks (repro.obs); null defaults are strict no-ops
        self.tracer = trace_lib.NULL
        self.runlog = runlog_lib.NULL

    def bind_obs(self, *, tracer=None, runlog=None) -> None:
        """Attach telemetry sinks; ``None`` leaves a sink unchanged."""
        if tracer is not None:
            self.tracer = tracer
        if runlog is not None:
            self.runlog = runlog

    # -- views ---------------------------------------------------------------
    @property
    def batch_size(self) -> int:
        return self.policy.batch_size

    @property
    def needs_diversity(self) -> bool:
        return self.policy.needs_diversity

    @property
    def compile_bound(self) -> int:
        """Max distinct step compilations this program can cost a StepEngine
        (the policy's bucket-lattice size; see BatchPolicy.max_buckets)."""
        return getattr(self.policy, "max_buckets", 1)

    # -- the boundary --------------------------------------------------------
    def observe(self, signals: Signals, clock: Clock) -> Applied | None:
        """Feed one boundary observation through the policy.

        Returns the applied record when the policy decided something OR the
        boundary is an epoch end (epoch boundaries always advance the epoch
        counter, apply the background lr decay, and append to history — the
        legacy controller contract); silent ticks return None.

        Every Applied record is also emitted to the bound run log as a
        ``decision`` event — the run-log decision stream mirrors
        ``self.history`` exactly, which is what lets ``launch/monitor.py``
        reconstruct the batch-size/lr schedule from the file alone.
        """
        with self.tracer.span("observe", boundary=clock.boundary,
                              epoch=clock.epoch, step=clock.step):
            applied = self._observe(signals, clock)
        if applied is not None and self.runlog.enabled:
            self.runlog.emit("decision", **dataclasses.asdict(applied))
        return applied

    def _observe(self, signals: Signals, clock: Clock) -> Applied | None:
        m_old = self.batch_size
        d = self.policy.observe(signals, clock)
        if d is not None:
            m_new = d.batch_size if d.batch_size is not None else m_old
            if d.lr is not None:
                self.lr = float(d.lr)
            else:
                self.lr = self.coupling.rescale(self.lr, m_old, m_new)
            if d.estimator is not None:
                self.estimator = d.estimator
        if clock.boundary == "epoch":
            self.lr = self.coupling.background(clock.epoch, self.lr)
            self.epoch = clock.epoch + 1
        if d is None and clock.boundary != "epoch":
            return None
        applied = Applied(
            epoch=clock.epoch,
            step=clock.step,
            boundary=clock.boundary,
            batch_size=self.batch_size,
            lr=self.lr,
            diversity=d.diversity if d is not None else signals.diversity,
            raw_batch_size=d.raw_batch_size if d is not None else None,
            reason=d.reason if d is not None else "",
            rescaled=self.batch_size != m_old,
            estimator=d.estimator if d is not None else None,
            rung=d.rung if d is not None else None,
        )
        self.history.append(applied)
        return applied

    # -- checkpointable state (schema v2; v1 accepted) -----------------------
    def state_dict(self) -> dict:
        return {
            "version": SCHEMA_VERSION,
            "policy": self.policy.state_dict(),
            "lr": self.lr,
            "base_lr": self.base_lr,
            "epoch": self.epoch,
            "estimator": self.estimator,
            "tick_every": self.tick_every,
            "history": [dataclasses.asdict(a) for a in self.history],
        }

    def load_state_dict(self, state: dict) -> None:
        version = int(state.get("version", 1))
        self.policy.load_state_dict(state["policy"])
        self.lr = float(state["lr"])
        self.epoch = int(state["epoch"])
        if version >= 2:
            self.base_lr = float(state.get("base_lr", self.base_lr))
            self.estimator = state.get("estimator", self.estimator)
            self.tick_every = int(state.get("tick_every", self.tick_every))
            self.history = [Applied(**a) for a in state.get("history", [])]
        else:
            # v1: the pre-redesign AdaptiveBatchController layout — history
            # entries are EpochDecision dicts (epoch-boundary only, no clock)
            self.history = [
                Applied(
                    epoch=int(h["epoch"]),
                    step=-1,
                    boundary="epoch",
                    batch_size=int(h["batch_size"]),
                    lr=float(h["lr"]),
                    diversity=h.get("diversity"),
                    raw_batch_size=h.get("raw_batch_size"),
                    rescaled=bool(h.get("rescaled", False)),
                )
                for h in state.get("history", [])
            ]
