"""Host-side training shell — the paper's Algorithm 1 end to end.

Counterpart of ``repro/train/loop.py``.  The ``Trainer`` is a thin host loop
over ``train/engine.py::StepEngine``: it owns the HOST decisions (the
adaptation program, the data cursor, eval cadence) and the engine owns the
device work (the SGD step, the diversity-tier accumulation, donation).
Each mini-batch is one SGD step, and the only per-step host transfer is the
scalar loss.

Adaptation runs through ``repro_torch.adapt``.  The 4th constructor
argument takes an ``adapt.AdaptationProgram`` or the legacy
``core.AdaptiveBatchController`` (a shim over a program).  Boundaries:

  * EPOCH ends (always): signals are read off the in-step accumulators (one
    stacked scalar transfer), fed to ``program.observe``, and the
    accumulators reset.
  * Every-k-steps TICKS (``program.tick_every > 0``) and injected EVENTS
    (``Trainer.inject_event``): observed BETWEEN steps with the running
    accumulators.  A mid-epoch decision resizes the batch — phase-aligned so
    the new size continues the epoch permutation at an exact multiple of
    itself — moves the elastic rung, and retargets lr/estimator before the
    next step.

Elastic mode (``elastic=MeshLadder(...)``, or a ``pod.PodLadder``): at any
boundary that resizes the batch the state moves onto the widest rung whose
dp width keeps the per-device microbatch >= the ladder granule, and the
engine's steps key by (bucket, tier, rung).  A ladder with ``engine_for``
(``PodLadder``) builds the engine itself: its cross-pod rungs run the
compressed step.  ``demote`` moves the live state onto the widest rung the
ladder's pod health still allows.  The feed keeps batches in flight
(``data.pipeline.prefetch``: on a card, pinned copies on a side stream;
``prefetch="thread"`` also overlaps the numpy gather, ``prefetch=False``
puts each batch when its step comes — the trajectory is the same in all
three).

The state lives on the device of the parameters passed in, or, in elastic
mode, of the live rung.  With ``donate=True`` (the default) the engine
trains the state's tensors in place; the initial placement onto a rung
copies (it must not alias the caller's parameters).

On ranks (a ladder of ``dist.plan.RankDevice`` entries, or an active rank
plan with ``--dp``) every rank runs this loop with the same data cursor,
and each rank's step takes its own slice of the global batch.  Every rank
must make the same decision, so at each boundary the first rank of the
control group (``MeshLadder.control``: the widest rung's group, on a
``PodLadder`` the healthy pods') reads the signals and evaluates, and its
``Signals`` and clock are broadcast; a rank outside a narrow rung skips the
steps (it holds no accumulators) and follows the decisions until a rung
takes it back in, when the state reaches it by broadcast
(``elastic.reshard``).  On a rung whose specs shard the state (an LM's;
the paper's small models match no rule) each rank holds its shard of
every leaf; ``save`` then has every rank of the rung form the
checkpoint's leaves, each gathered whole as the first rank writes it.
Injected events are the first rank's.

Checkpointing (``ckpt=CheckpointManager(...)``, ``save``, ``resume``, and
``ckpt_every`` epochs between automatic saves) captures the full adaptive
state in the reference's format and paths (``interop.reference_state``):
a checkpoint written by either package resumes in the other.  As in the
reference, no RNG state is stored: the epoch permutation is a function of
``(seed, epoch)``, and program schema v1 and v2 both load.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch import interop
from repro_torch.adapt import (
    AdaptationProgram,
    Clock,
    Signals,
    ThroughputWindow,
    read_signals,
)
from repro_torch.core import diversity
from repro_torch.core.controller import AdaptiveBatchController
from repro_torch.data import ArrayDataset, Cursor, EpochLoader
from repro_torch.data.pipeline import epoch_permutation, prefetch as prefetch_iter
from repro_torch.data.pipeline import put_global_batch
from repro_torch.dist import sharding
from repro_torch.dist.plan import broadcast_object, current_plan, process_rank
from repro_torch.elastic import MeshLadder, place, reshard
from repro_torch.obs import runlog as runlog_lib
from repro_torch.obs import trace as trace_lib
from repro_torch.train.engine import ModelFns, StepEngine, eval_fn_for
from repro_torch.train.state import TrainState, init_state
from repro_torch.utils import pytree as ptu
from repro_torch.utils.logging import get_logger

log = get_logger("train")

__all__ = ["ModelFns", "EpochRecord", "Trainer"]

#: estimator tiers that run inside the step
_INJIT_TIERS = ("exact", "gram", "moment")


def _lr(x: float) -> float:
    """The float32 value of an lr, as the reference's ``jnp.float32(lr)``."""
    return float(np.float32(x))


@dataclasses.dataclass
class EpochRecord:
    epoch: int
    batch_size: int
    lr: float
    train_loss: float
    val_loss: float
    val_metrics: dict
    diversity: float | None
    steps: int
    wall_s: float


class Trainer:
    def __init__(
        self,
        fns: ModelFns,
        params: Any,
        optimizer,
        controller: AdaptiveBatchController | AdaptationProgram,
        train_data: ArrayDataset,
        val_data: ArrayDataset,
        *,
        estimator: str = "exact",  # exact | gram | moment | oracle | none
        seed: int = 0,
        psn_microbatch: int = 256,
        ckpt=None,
        ckpt_every: int = 0,
        donate: bool = True,
        engine: StepEngine | None = None,
        elastic: MeshLadder | None = None,
        prefetch: bool | str = True,
        tracer=None,
        runlog=None,
    ):
        self.fns = fns
        self._tracer = trace_lib.NULL
        self._runlog = runlog_lib.NULL
        self.optimizer = optimizer
        self.controller = controller  # legacy view; may BE the program
        self.adapt = (
            controller.program
            if isinstance(controller, AdaptiveBatchController)
            else controller
        )
        self.train_data = train_data
        self.val_data = val_data
        self.estimator = estimator
        self.seed = seed
        self.psn_microbatch = psn_microbatch  # exact-tier vmap width / oracle chunk
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.cursor = Cursor()
        self.history: list[EpochRecord] = []
        self._events: list[str] = []  # injected, consumed between steps
        self.state: TrainState = init_state(params, optimizer)
        self._plan = current_plan()
        if elastic is not None and self._plan is not None:
            raise ValueError(
                "Trainer(elastic=...) under an ambient dist plan is ambiguous: "
                "the ladder owns the sharding plan per rung — drop the "
                "use_plan context (or the elastic ladder)"
            )
        self._elastic = elastic
        self._rung = None
        if prefetch not in (True, False, "thread"):
            raise ValueError(
                f"prefetch must be True, False, or 'thread', got {prefetch!r}"
            )
        self._prefetch = prefetch
        self._stream = None  # the feed's side stream on a card
        self._thru = ThroughputWindow()
        mesh = (elastic.full.plan.mesh if elastic is not None
                else self._plan.mesh if self._plan is not None else None)
        #: whether the run spans ranks (a rank ladder or rank plan)
        self.ranked = mesh is not None and getattr(mesh, "ranked", False)
        self._me = process_rank()
        self.engine = engine or self._build_engine(donate)
        # an injected engine may lack an eval fn; the Trainer owns the fns
        self.engine.ensure_eval_fn(eval_fn_for(fns))
        self.bind_obs(tracer=tracer, runlog=runlog)
        if self._elastic is not None:
            # initial placement: the rung for the starting batch size
            self._ensure_rung(self.adapt.batch_size)
        elif self.ranked:
            # every rank starts from the first rank's parameters
            self.state = reshard(self.state, None, self._plan, donate=True)

    def _build_engine(self, donate: bool) -> StepEngine:
        # The ladder supplies the engine (duck-typed so the base Trainer never
        # imports repro_torch.pod): PodLadder builds the compressed cross-pod
        # step on pods>1 rungs, a rank ladder the dp step over each rung.
        engine_for = getattr(self._elastic, "engine_for", None)
        if engine_for is not None:
            return engine_for(
                self.fns,
                self.optimizer,
                estimator=self.estimator,
                diversity_on=self.adapt.needs_diversity,
                donate=donate,
                psn_chunk=self.psn_microbatch,
            )
        return StepEngine.for_model_fns(
            self.fns,
            self.optimizer,
            estimator=self.estimator,
            diversity_on=self.adapt.needs_diversity,
            donate=donate,
            psn_chunk=self.psn_microbatch,
            plan=self._plan if self.ranked else None,
        )

    # -- read-only views of the engine-owned state ---------------------------
    @property
    def params(self):
        return self.state.params

    @property
    def opt_state(self):
        return self.state.opt_state

    @property
    def div_state(self):
        return self.state.div_state

    @property
    def rung(self):
        """The live elastic ladder rung (None outside elastic mode)."""
        return self._rung

    @property
    def elastic(self):
        """The elastic ladder driving this trainer (None outside elastic
        mode); pod health is reached through it."""
        return self._elastic

    @property
    def device(self) -> torch.device:
        """Where the state and the batches live."""
        return ptu.leaves(self.state.params)[0].device

    # -- ranks ---------------------------------------------------------------
    def _control(self) -> tuple[Any, tuple[int, ...]]:
        """``(group, ranks)`` the decisions travel over; the first rank
        decides."""
        if self._elastic is not None:
            return self._elastic.control()
        mesh = self._plan.mesh
        return mesh.group(mesh.axis_names), mesh.group_ranks(mesh.axis_names)

    @property
    def is_root(self) -> bool:
        """Whether this rank decides (always, off ranks)."""
        return not self.ranked or self._me == self._control()[1][0]

    @property
    def in_rung(self) -> bool:
        """Whether this rank steps the live rung (always, off ranks)."""
        return not self.ranked or self._rung is None or self._rung.plan.mesh.is_member

    def _share(self, obj: Any) -> Any:
        """The deciding rank's ``obj`` on every rank of the control group
        (``obj`` itself off ranks)."""
        if not self.ranked:
            return obj
        group, ranks = self._control()
        return broadcast_object(obj, ranks[0], group, self.device)

    # ------------------------------------------------------------------
    def bind_obs(self, *, tracer=None, runlog=None) -> None:
        """Attach telemetry sinks (``repro_torch.obs``) to the trainer, its
        engine and its adaptation program.  ``None`` leaves a sink
        unchanged."""
        if tracer is not None:
            self._tracer = tracer
            self.engine.tracer = tracer
        if runlog is not None:
            self._runlog = runlog
            self.engine.runlog = runlog
        bind = getattr(self.adapt, "bind_obs", None)
        if bind is not None:
            bind(tracer=tracer, runlog=runlog)

    def inject_event(self, name: str) -> None:
        """Queue an external event (e.g. a straggler flag).  Consumed
        BETWEEN steps at the next opportunity: the adapt program observes it
        with ``boundary='event'``."""
        self._events.append(str(name))
        if self._runlog.enabled:
            self._runlog.emit("inject", name=str(name),
                              epoch=self.cursor.epoch,
                              step=self.engine.stats.steps)

    def _ensure_rung(self, batch_size: int) -> None:
        """Elastic transition onto the ladder rung for ``batch_size``; a
        strict no-op when the rung is unchanged."""
        if self._elastic is None:
            return
        self._transition(self._elastic.rung_for_batch(batch_size),
                         note=f"for batch {batch_size}")

    def _transition(self, rung, note: str = "") -> None:
        if self._rung is not None and rung.index == self._rung.index:
            return
        src = self._rung
        # the initial placement must NOT donate: the state still aliases the
        # caller-passed params at that point (transitions own their buffers)
        with self._tracer.span("reshard", scope="train",
                               src=src.index if src else None,
                               dst=rung.index, dp=rung.dp):
            self.state = reshard(
                self.state, src.plan if src else None, rung.plan,
                donate=self.engine.donate and src is not None,
            )
        self._rung = rung
        self.engine.rung = rung.index
        # ladder-specific state (PodLadder's compression residuals) is
        # installed/dropped AFTER the move so it lands on the new device
        self.state = self._elastic.adapt_state(self.state, src, rung)
        if src is not None:  # initial placement is not a transition
            self.engine.stats.reshards += 1
            if self._runlog.enabled:
                self._runlog.emit("reshard", scope="train", src=src.index,
                                  dst=rung.index, dp=rung.dp,
                                  epoch=self.cursor.epoch,
                                  step=self.engine.stats.steps,
                                  note=note)
            log.info("elastic: rung %d -> %d (dp %d -> %d) %s",
                     src.index, rung.index, src.dp, rung.dp, note)

    def demote(self, note: str = "pod lost") -> tuple[int | None, int]:
        """Degrade-don't-restart: move the LIVE state onto the widest rung the
        (health-filtered) ladder still allows for the current batch size.
        Returns ``(src_rung_index, dst_rung_index)``; a no-op transition
        returns the same index twice."""
        if self._elastic is None:
            raise ValueError("demote() needs an elastic ladder")
        src = self._rung.index if self._rung is not None else None
        self._transition(self._elastic.rung_for_batch(self.adapt.batch_size),
                         note=note)
        return src, self._rung.index

    def _put(self, batch_np: dict) -> dict:
        return put_global_batch(batch_np, self.device)

    def _feed_stream(self):
        """The side stream batches are copied on, on a card (None on the
        CPU)."""
        dev = self.device
        if dev.type != "cuda":
            return None
        if self._stream is None or self._stream.device != dev:
            self._stream = torch.cuda.Stream(dev)
        return self._stream

    def _oracle_diversity(self) -> float:
        batches = (
            self._put(self.train_data.get(idx))
            for idx in np.array_split(
                np.arange(len(self.train_data)),
                max(1, len(self.train_data) // self.psn_microbatch),
            )
        )
        return float(diversity.dataset_diversity(
            self.fns.example_loss, self.state.params, batches))

    def _throughput(self) -> float:
        """Windowed steps/s; the run-global dispatch average only before the
        first step lands in the window."""
        rate = self._thru.rate()
        return rate if rate is not None else self.engine.stats.dispatch_steps_per_sec

    # -- decision plumbing ----------------------------------------------------
    def _read_estimator(self) -> str:
        """The tier signals are decoded with: the in-step tier when one is
        active; 'exact' for estimator='none'; 'moment' for oracle."""
        if self.estimator in _INJIT_TIERS:
            return self.estimator
        return "moment" if self.estimator == "oracle" else "exact"

    def _apply_estimator(self, tier: str | None) -> None:
        """Retarget the diversity tier from a Decision: a new step key on a
        tier-parameterised engine, a rebuilt engine (stats carried over)
        otherwise."""
        if tier is None or tier == self.estimator:
            return
        if tier not in _INJIT_TIERS:
            raise ValueError(
                f"decision estimator must be one of {_INJIT_TIERS}, got {tier!r}"
            )
        log.info("adapt: estimator tier %s -> %s", self.estimator, tier)
        self.estimator = tier
        if self.engine.tiered:
            self.engine.tier = tier
            return
        stats, rung_token = self.engine.stats, self.engine.rung
        self.engine = self._build_engine(self.engine.donate)
        self.engine.ensure_eval_fn(eval_fn_for(self.fns))
        self.engine.stats = stats
        self.engine.rung = rung_token

    def _apply_decision(self, applied) -> None:
        """Non-batch effects of an applied decision."""
        if applied is None:
            return
        self._apply_estimator(applied.estimator)
        if applied.rung is not None and self._elastic is not None:
            self._transition(self._elastic.rungs[applied.rung], note="(explicit)")

    def _observe_mid_epoch(self, steps_done: int, bsz: int,
                           last_loss: float) -> Any:
        """Tick/event boundaries between steps.  Reads the RUNNING
        accumulators (one stacked-scalar transfer), only when a boundary is
        due AND the policy can fire on it.  Explicit-rung decisions are
        applied by the step loop, which must also rebuild the feed."""
        clock = event = sig = None
        if not self.is_root:
            self._events.clear()  # the deciding rank's events count
        elif self._events:
            c = Clock(epoch=self.cursor.epoch, step=self.engine.stats.steps,
                      boundary="event")
            if self.adapt.policy.fires(c):
                event, clock = self._events.pop(0), c
            else:
                log.info("adapt: event %r dropped (policy does not fire on "
                         "events)", self._events.pop(0))
        if (self.is_root and clock is None and self.adapt.tick_every
                and steps_done % self.adapt.tick_every == 0):
            c = Clock(epoch=self.cursor.epoch, step=self.engine.stats.steps,
                      boundary="tick")
            if self.adapt.policy.fires(c):
                clock = c
        if clock is not None:
            sig, self.state = read_signals(
                self.state, self._read_estimator(), reset=False,
                batch_size=bsz, loss=last_loss,
                throughput=self._throughput(), event=event,
            )
        clock, sig = self._share((clock, sig))
        if clock is None:
            return None
        applied = self.adapt.observe(sig, clock)
        if applied is not None:
            self._apply_estimator(applied.estimator)
        return applied

    def _epoch_signals(self, bsz: int, mean_loss: float) -> Signals:
        """Epoch-boundary signals: read + RESET the accumulators; the oracle
        tier substitutes the exact full-dataset diversity."""
        if not self.adapt.needs_diversity:
            return Signals(loss=mean_loss, batch_size=bsz,
                           throughput=self._throughput())
        sig, self.state = read_signals(
            self.state, self._read_estimator(), reset=True,
            batch_size=bsz, loss=mean_loss,
            throughput=self._throughput(),
        )
        if self.estimator == "oracle":
            sig = dataclasses.replace(sig, diversity=self._oracle_diversity())
        return sig

    # ------------------------------------------------------------------
    def run_epoch(self) -> EpochRecord:
        tr = self._tracer
        if not tr.enabled:
            return self._run_epoch()
        with tr.span("epoch", epoch=self.cursor.epoch):
            return self._run_epoch()

    def _run_epoch(self) -> EpochRecord:
        t0 = time.time()
        prog = self.adapt
        bsz = prog.batch_size
        self._ensure_rung(bsz)
        lr = _lr(prog.lr)
        n = len(self.train_data)
        consumed = self.cursor.sample_index or self.cursor.batch_index * bsz
        losses: list[float] = []
        n_steps = 0
        # one O(n) shuffle per epoch, shared by every resize segment's loader
        perm = epoch_permutation(n, self.seed, self.cursor.epoch)

        # One (epoch, batch-size, rung) segment per inner loop: a mid-epoch
        # resize or explicit rung move breaks out, and the next loader
        # continues the SAME permutation at the exact sample offset consumed.
        while True:
            target = prog.batch_size
            if target != bsz and consumed % target == 0:
                bsz = target
                lr = _lr(prog.lr)
                self._ensure_rung(bsz)
            loader = EpochLoader(
                self.train_data, bsz, epoch=self.cursor.epoch, seed=self.seed,
                start_sample=consumed, perm=perm,
            )
            if len(loader) == 0:
                break
            if not self.in_rung:  # outside the rung: follow the steps only
                feed = (None for _ in range(len(loader)))
            elif self._prefetch:
                feed = prefetch_iter(loader, put=self._put,
                                     host_overlap=self._prefetch == "thread",
                                     stream=self._feed_stream())
            else:
                feed = (self._put(b) for b in loader)
            rebuild = False
            try:
                for batch in feed:
                    if batch is not None:
                        self.state, metrics = self.engine.step(self.state, batch, lr)
                        losses.append(float(metrics["loss"]))  # per-step sync
                        self._thru.add(1.0)
                    n_steps += 1
                    consumed += bsz
                    self.cursor.batch_index += 1
                    self.cursor.sample_index = consumed
                    applied = self._observe_mid_epoch(
                        self.cursor.batch_index, bsz,
                        losses[-1] if losses else float("nan"))
                    if (applied is not None and applied.rung is not None
                            and self._elastic is not None):
                        # explicit rung move: move, then rebuild the feed
                        self._transition(self._elastic.rungs[applied.rung],
                                         note="(explicit)")
                        rebuild = True
                        break
                    # Phase-aligned resize: apply a pending target size once
                    # the consumed offset is a multiple of it; the coupled lr
                    # retarget lands with the resize.
                    target = prog.batch_size
                    if target != bsz:
                        if consumed % target == 0:
                            bsz = target
                            lr = _lr(prog.lr)
                            self._ensure_rung(bsz)
                            rebuild = True
                            break
                    elif applied is not None:
                        lr = _lr(prog.lr)
            finally:
                close = getattr(feed, "close", None)
                if close is not None:
                    close()
            if not rebuild:
                break

        # epoch boundary: the deciding rank reads the signals and evaluates
        # (the parameters do not change before the evaluation), the other
        # ranks of the rung reset their accumulators ----------------------
        found = None
        if self.is_root:
            mean_loss = float(np.mean(losses)) if losses else float("nan")
            sig = self._epoch_signals(bsz, mean_loss)
            clock = Clock(epoch=self.cursor.epoch, step=self.engine.stats.steps,
                          boundary="epoch")
            val = self._put(self.val_data.get(np.arange(len(self.val_data))))
            val_loss, val_metrics = self.engine.evaluate(self.state.params, val)
            found = (sig, clock, mean_loss, float(val_loss),
                     {k: float(v) for k, v in val_metrics.items()})
        elif self.in_rung and self.adapt.needs_diversity:
            diversity.reset_state(self.state.div_state)
        sig, clock, mean_loss, val_loss, val_metrics = self._share(found)
        applied = prog.observe(sig, clock)
        self._apply_decision(applied)

        rec = EpochRecord(
            epoch=self.cursor.epoch,
            batch_size=prog.batch_size,
            lr=prog.lr,
            train_loss=mean_loss,
            val_loss=val_loss,
            val_metrics=val_metrics,
            diversity=sig.diversity,
            steps=n_steps,
            wall_s=time.time() - t0,
        )
        self.history.append(rec)
        if self._runlog.enabled:
            self._runlog.emit(
                "epoch", epoch=rec.epoch, steps=rec.steps,
                batch_size=rec.batch_size, lr=rec.lr, loss=rec.train_loss,
                val_loss=rec.val_loss, diversity=rec.diversity,
                gns=sig.gns, throughput=sig.throughput,
                rung=self._rung.index if self._rung is not None else None,
                wall_s=rec.wall_s,
            )
        self.cursor.epoch += 1
        self.cursor.batch_index = 0
        self.cursor.sample_index = 0
        if self.ckpt and self.ckpt_every and self.cursor.epoch % self.ckpt_every == 0:
            self.save()
        return rec

    def run(self, epochs: int, verbose: bool = True) -> list[EpochRecord]:
        for _ in range(epochs):
            rec = self.run_epoch()
            if verbose:
                log.info(
                    "epoch %d: loss=%.4f val=%.4f metrics=%s m=%d lr=%.4g div=%s",
                    rec.epoch, rec.train_loss, rec.val_loss, rec.val_metrics,
                    rec.batch_size, rec.lr,
                    f"{rec.diversity:.4g}" if rec.diversity is not None else "-",
                )
        return self.history

    # ------------------------------------------------------------------
    def save(self):
        """Checkpoint the full state at the current epoch: every tensor is on
        the host before this returns (the next step updates them in
        place)."""
        if self.ckpt is None:
            raise ValueError("save() needs a CheckpointManager (Trainer(ckpt=...))")
        state = extra = None
        # on ranks, the deciding rank writes; a sharded state's leaves are
        # gathered as they are formed, on every rank of its rung
        if self.is_root or sharding.layout_of(self.state.params) is not None:
            ref = interop.reference_state(self.state)
            state = {"params": ref.params, "opt_state": ref.opt_state,
                     "div_state": ref.div_state}
        if self.is_root:
            extra = {
                "controller": self.adapt.state_dict(),
                "cursor": self.cursor.state_dict(),
                "history": [dataclasses.asdict(r) for r in self.history],
                "step": int(self.state.step),
            }
        group, ranks = self._control() if self.ranked else (None, (None,))
        self.ckpt.save(step=self.cursor.epoch, state=state, extra=extra,
                       group=group, root=ranks[0])
        if self._runlog.enabled:
            self._runlog.emit("checkpoint", epoch=self.cursor.epoch,
                              step=int(self.state.step))

    def resume(self) -> bool:
        """Restore the latest checkpoint (False when there is none).  With a
        ladder, the rung is the one for the RESTORED batch size, chosen
        before the state is placed; its ladder state (the compression
        residuals) is installed afresh."""
        if self.ckpt is None:
            raise ValueError("resume() needs a CheckpointManager (Trainer(ckpt=...))")
        if self.ckpt.latest_step() is None:
            return False
        ref = interop.reference_state(self.state, target=True)
        out, extra = self.ckpt.restore(
            {"params": ref.params, "opt_state": ref.opt_state, "div_state": ref.div_state})
        # both schema versions load (v1: pre-redesign controller dicts)
        self.adapt.load_state_dict(extra["controller"])
        self.cursor.load_state_dict(extra["cursor"])
        self.history = [EpochRecord(**r) for r in extra.get("history", [])]
        if self._elastic is not None:
            rung = self._elastic.rung_for_batch(self.adapt.batch_size)
            self._rung = rung
            self.engine.rung = rung.index
            self.state = place(self.state._replace(err_state=None), rung.plan)
        self.state = interop.load_reference_state(
            self.state, step=extra.get("step", 0), **out)
        if self._elastic is not None:
            # checkpoints never carry ladder state (the residuals are
            # transient wire state): install it for the restored rung
            self.state = self._elastic.adapt_state(self.state, None, self._rung)
        log.info("resumed from epoch %d", self.cursor.epoch)
        return True
