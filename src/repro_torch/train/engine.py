"""StepEngine: the one training path, keyed by batch bucket.

Counterpart of ``repro/train/engine.py``.  The engine owns

  * a cache of step functions keyed like the reference's compile cache, by
    (bucket, tier, rung, batch signature).  Eager PyTorch compiles nothing,
    so the cache is key accounting: ``EngineStats`` counts a "compile" per
    new key and a hit per reuse, which keeps ``compiles``, ``bucket_hits``,
    ``buckets``, ``rungs`` and ``tiers`` comparable with the reference
    engine (``compile_s`` stays 0).  A build of ``(key, tier)`` makes the
    engine tier-parameterised: setting ``engine.tier`` switches the in-step
    estimator, and a flip back onto a seen tier is a hit.  A build of
    ``(key, tier, rung)`` is rung-aware: ``engine.rung`` (the elastic
    ladder's rung index, set by the ``Trainer``) is passed to it, so a
    ladder can build a different step per rung (``pod.PodLadder`` builds the
    compressed cross-pod step on its cross-pod rungs);
  * donation: with ``donate=True`` (the default) the step updates the
    caller's state in place, so the steady-state footprint is one state;
    with ``donate=False`` it steps a copy and the caller's ``TrainState``
    keeps its old values, as the reference's undonated buffers do;
  * the step of ``train/step.py::make_train_step`` with the diversity tier
    inside it: no per-step host transfer;
  * telemetry (``tracer=``, ``runlog=``, ``repro_torch.obs``): a new step key
    opens a ``compile`` span and emits a run-log ``compile`` event, and each
    step runs under a ``dispatch`` span, with the reference's names and
    fields, so one monitor reads both packages' logs.  The null defaults
    cost one attribute load and a branch per step.

``for_model_fns`` builds the engine of the paper's small models
(``ModelFns``), ``for_lm`` the LM's.  The gram tier on the LM runs on a
hand-built engine: ``StepEngine(lambda n, tier: make_train_step(cfg, opt,
n, estimator=tier, probe_loss=..., probe_specs=...), lm_bucket_of(m))``.
``for_lm(dp_size=, plan=)`` trains data-parallel: under a rank plan (a
``dist.ShardingPlan`` over ``(rank, device)`` entries) each rank runs its
share of every microbatch and the gradients are averaged over the plan's
dp group (``train/step.py``); a state placed on the plan
(``elastic.reshard.place``) is sharded, and the step gathers its blocks.
"""

from __future__ import annotations

import copy
import dataclasses
import inspect
import time
from typing import Callable

import torch

from repro_torch.dist.plan import ShardingPlan, current_plan
from repro_torch.obs import metrics as metrics_lib
from repro_torch.obs import runlog as runlog_lib
from repro_torch.obs import trace as trace_lib
from repro_torch.optim import Optimizer
from repro_torch.train import step as step_lib
from repro_torch.train.state import TrainState


@dataclasses.dataclass
class ModelFns:
    """Functions defining a (non-LM) trainee, as in the reference.

    batch_loss(params, batch) -> scalar mean loss
    example_loss(params, example) -> scalar (per-sample; exact tier)
    metrics(params, batch) -> dict                    [optional]
    probe_loss(params, probes, batch) -> (loss, acts) [gram tier, optional]
    probe_specs(params, batch_size) -> probes         [gram tier, optional]
    """

    batch_loss: Callable
    example_loss: Callable | None = None
    metrics: Callable | None = None
    probe_loss: Callable | None = None
    probe_specs: Callable | None = None


def eval_fn_for(fns: ModelFns) -> Callable:
    """The standard eval over ModelFns: (params, batch) -> (loss, metrics)."""

    def eval_fn(params, batch):
        loss = fns.batch_loss(params, batch)
        metrics = fns.metrics(params, batch) if fns.metrics else {}
        return loss, metrics

    return eval_fn


class EngineStats(metrics_lib.StatsView):
    """Observable engine behaviour, with the reference's ``as_dict()`` keys.

    ``compiles`` counts distinct step keys, one per (bucket, rung, tier,
    batch-signature) tuple; ``bucket_hits`` / ``bucket_misses`` count
    lookups; ``buckets`` lists the bucket of each new key in order, and
    ``rungs`` / ``tiers`` its rung and tier; ``reshards`` counts rung
    transitions applied to the engine-owned state.  ``dispatch_wall_s`` is
    host time spent in ``step``: the step enqueues its device work and
    returns, so it is not end-to-end throughput.  The scalar fields are
    views over the ``repro_torch.obs`` metrics registry (namespace
    ``train.engine.<n>``).
    """

    _COUNTERS = ("compiles", "bucket_hits", "bucket_misses", "steps", "reshards")
    _GAUGES = ("compile_s", "dispatch_wall_s")

    def __init__(self, donate: bool = True, *,
                 registry: metrics_lib.Registry | None = None):
        self.donate = donate
        self.buckets: list[int] = []
        self.rungs: list = []
        self.tiers: list = []
        self._init_metrics("train.engine", registry)

    @property
    def dispatch_steps_per_sec(self) -> float:
        return self.steps / self.dispatch_wall_s if self.dispatch_wall_s > 0 else 0.0

    def as_dict(self) -> dict:
        return {
            "compiles": self.compiles,
            "bucket_hits": self.bucket_hits,
            "bucket_misses": self.bucket_misses,
            "steps": self.steps,
            "compile_s": self.compile_s,
            "reshards": self.reshards,
            "dispatch_wall_s": self.dispatch_wall_s,
            "donate": self.donate,
            "buckets": list(self.buckets),
            "rungs": list(self.rungs),
            "tiers": list(self.tiers),
            "dispatch_steps_per_sec": self.dispatch_steps_per_sec,
        }


def lm_bucket_of(micro_batch: int | None) -> Callable[[dict], int]:
    """The LM engines' bucket key: a global batch of B sequences runs as
    ``B // micro_batch`` microbatches."""

    def bucket_of(batch: dict) -> int:
        if micro_batch is None:
            raise ValueError(
                "StepEngine.for_lm was built without micro_batch: use "
                ".jitted(num_micro) directly, or pass micro_batch= to "
                "enable .step()")
        b = int(next(iter(batch.values())).shape[0])
        if b % micro_batch != 0:
            raise ValueError(
                f"global batch {b} is not a multiple of micro_batch "
                f"{micro_batch}; batch sizes must land on the bucket "
                f"lattice (core/batch_policy.bucket)")
        return max(b // micro_batch, 1)

    return bucket_of


def _leading_dim(batch: dict) -> int:
    return int(next(iter(batch.values())).shape[0])


class StepEngine:
    """Bucketed step cache around ``make_train_step``.

    ``build_step(key)`` returns the step function of one bucket key;
    ``bucket_of(batch)`` maps a batch to its key (default: the leading dim
    of the first leaf, which the batch policies snap to the pow2 lattice).
    ``build_step`` may instead take ``(key, tier)``: the engine is then
    tier-parameterised, and ``engine.tier`` (None until set) is passed to
    the build and keys the cache.  A third positional parameter,
    ``(key, tier, rung)``, makes the build rung-aware: ``engine.rung`` is
    passed through and keys the cache too.  Only positional parameters
    count, so a build binds other values as keyword-only parameters.  As in
    the reference, setting ``tier`` on an engine whose build takes no tier
    raises at the next step.
    """

    def __init__(self, build_step: Callable[..., Callable],
                 bucket_of: Callable[[dict], int] | None = None, *,
                 donate: bool = True, eval_fn: Callable | None = None,
                 tracer=None, runlog=None):
        self._build = build_step
        # telemetry sinks (repro_torch.obs); the null defaults are no-ops
        self.tracer = tracer if tracer is not None else trace_lib.NULL
        self.runlog = runlog if runlog is not None else runlog_lib.NULL
        self._bucket_of = bucket_of or _leading_dim
        # only positional parameters count: a (key, **opts) or keyword-only
        # second parameter cannot take a positional tier
        n_params = sum(1 for p in inspect.signature(build_step).parameters.values()
                       if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD))
        #: whether build_step takes the tier (see the class docstring)
        self.tiered = n_params >= 2
        #: whether build_step also takes the rung (see the class docstring)
        self.rung_aware = n_params >= 3
        #: the active estimator tier, part of every step key
        self.tier = None
        #: the elastic ladder's rung token (the Trainer sets the rung index)
        self.rung = None
        self.donate = donate
        self._eval_fn = eval_fn
        self._steps: dict[tuple, Callable] = {}
        self._keys: set[tuple] = set()
        self.stats = EngineStats(donate=donate)

    # -- step cache ------------------------------------------------------------
    def jitted(self, key: int) -> Callable:
        """The step function of bucket ``key`` at the active tier (and rung),
        built on first use (the reference's name for its not-yet-compiled
        jit)."""
        if self.tier is not None and not self.tiered:
            raise ValueError(
                "engine.tier was set but build_step takes no tier argument; "
                "tier flips on hand-built engines need a (key, tier) build")
        skey = (key, self.tier, self.rung if self.rung_aware else None)
        if skey not in self._steps:
            if self.rung_aware:
                fn = self._build(key, self.tier, self.rung)
            elif self.tiered:
                fn = self._build(key, self.tier)
            else:
                fn = self._build(key)
            self._steps[skey] = fn
        return self._steps[skey]

    def _executable(self, key: int, batch: dict) -> Callable:
        sig = (key, self.rung, self.tier, tuple(batch),
               tuple((tuple(v.shape[1:]), str(v.dtype)) for v in batch.values()))
        if sig in self._keys:
            self.stats.bucket_hits += 1
            return self.jitted(key)
        self.stats.bucket_misses += 1
        t0 = time.perf_counter()
        with self.tracer.span("compile", scope="train", bucket=key, rung=self.rung,
                              tier=str(self.tier)):
            fn = self.jitted(key)
        dt = time.perf_counter() - t0
        if self.runlog.enabled:
            self.runlog.emit("compile", scope="train", what=f"bucket={key}", seconds=dt,
                             bucket=key, rung=self.rung, tier=str(self.tier))
        self.stats.compiles += 1
        self.stats.buckets.append(key)
        self.stats.rungs.append(self.rung)
        self.stats.tiers.append(self.tier)
        self._keys.add(sig)
        return fn

    # -- stepping --------------------------------------------------------------
    def step(self, state: TrainState, batch: dict, lr) -> tuple[TrainState, dict]:
        """One optimizer step at whatever bucket ``batch`` lands on.  With
        donation the state is updated in place and returned; without it the
        step runs on a copy and ``state`` is left as it was."""
        key = self._bucket_of(batch)
        fn = self._executable(key, batch)
        t0 = time.perf_counter()
        if not self.donate:
            state = copy.deepcopy(state)
        tr = self.tracer
        if tr.enabled:
            with tr.span("dispatch", bucket=key, rung=self.rung, tier=str(self.tier),
                         step_num=self.stats.steps):
                out = fn(state, batch, lr)
        else:
            out = fn(state, batch, lr)
        self.stats.dispatch_wall_s += time.perf_counter() - t0
        self.stats.steps += 1
        return out

    @torch.no_grad()
    def evaluate(self, params, batch: dict):
        """(loss, metrics) on a batch; the parameters are not changed."""
        if self._eval_fn is None:
            raise ValueError("engine was built without an eval_fn")
        return self._eval_fn(params, batch)

    def ensure_eval_fn(self, eval_fn: Callable) -> None:
        """Install ``eval_fn(params, batch) -> (loss, metrics)`` if the engine
        has none — lets the Trainer accept hand-built/injected engines."""
        if self._eval_fn is None:
            self._eval_fn = eval_fn

    # -- constructors ----------------------------------------------------------
    @classmethod
    def for_model_fns(cls, fns: ModelFns, optimizer: Optimizer, *,
                      estimator: str = "moment", diversity_on: bool = True,
                      donate: bool = True, psn_chunk: int | None = None,
                      psn_impl: str = "auto",
                      plan: ShardingPlan | None = None) -> "StepEngine":
        """Engine over ``ModelFns`` (the paper's reference models).

        One bucket = one global batch size; ``num_micro`` is 1, so each batch
        is exactly one SGD step (Algorithm 1's step granularity).  The build
        is tier-parameterised: the engine starts on ``estimator`` and a later
        ``engine.tier = "gram"`` builds that tier's steps beside the old
        ones.  Under a rank ``plan`` each rank steps its share of the batch
        and the gradients are averaged over the plan's dp group."""
        injit = ("exact", "gram", "moment")

        def build(key: int, tier: str | None = None) -> Callable:
            est = tier if tier is not None else estimator
            track = diversity_on and est in injit
            return step_lib.make_train_step(
                None, optimizer, 1,
                diversity_on=track,
                loss_fn=fns.batch_loss,
                estimator=est if track else "moment",
                example_loss=fns.example_loss,
                probe_loss=fns.probe_loss,
                probe_specs=fns.probe_specs,
                psn_chunk=psn_chunk,
                psn_impl=psn_impl,
                plan=plan,
            )

        eng = cls(build, donate=donate, eval_fn=eval_fn_for(fns))
        if diversity_on and estimator in injit:
            # name the starting tier so a flip away and back shares the key
            eng.tier = estimator
        return eng

    @classmethod
    def for_lm(cls, cfg, optimizer: Optimizer, *, micro_batch: int | None = None,
               dp_size: int = 1, moe_groups: int = 1, diversity_on: bool = True,
               attn_impl: str | None = None, donate: bool = True,
               plan: ShardingPlan | None = None) -> "StepEngine":
        """Engine over the transformer LM loss (the production path).

        One bucket is one ``num_micro`` (accumulation length): the bucket of
        a global batch of B sequences is ``B // micro_batch`` (the global
        microbatch; under a rank plan each of the dp ranks takes
        ``micro_batch / dp_size`` of it).  ``attn_impl`` overrides
        ``cfg.attn_impl`` for the training forward ("pallas" puts
        attention, forward and backward, on the kernels).  ``dp_size`` is
        the data-parallel width, ``plan`` (default: the active plan) a rank
        plan whose dp group the gradients are averaged over.
        ``moe_groups`` is the number of routing groups of a global
        microbatch's tokens (a MoE model's FFNs; under a rank plan each rank
        routes ``moe_groups / dp_size`` of them)."""
        if attn_impl is not None:
            cfg = cfg.replace(attn_impl=attn_impl)
        plan = plan if plan is not None else current_plan()

        def build(num_micro: int, tier: str | None = None) -> Callable:
            return step_lib.make_train_step(
                cfg, optimizer, num_micro, dp_size=dp_size, moe_groups=moe_groups,
                plan=plan, diversity_on=diversity_on,
                **({"estimator": tier} if tier is not None else {}))

        eng = cls(build, lm_bucket_of(micro_batch), donate=donate)
        if diversity_on:
            # name the default tier so a flip away and back lands on the warm key
            eng.tier = "moment"
        return eng
