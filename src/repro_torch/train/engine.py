"""StepEngine: the one training path, keyed by batch bucket.

Counterpart of ``repro/train/engine.py``.  The engine owns

  * a cache of step functions keyed like the reference's compile cache, by
    (bucket, tier, batch signature).  Eager PyTorch compiles nothing, so the
    cache is key accounting: ``EngineStats`` counts a "compile" per new key
    and a hit per reuse, which keeps ``compiles``, ``bucket_hits`` and
    ``buckets`` comparable with the reference engine (``compile_s`` stays 0).
    A build of ``(key, tier)`` makes the engine tier-parameterised: setting
    ``engine.tier`` switches the in-step estimator, and a flip back onto a
    seen tier is a hit;
  * donation: the step updates the state's tensors in place, so the
    steady-state footprint is one state;
  * the step of ``train/step.py::make_train_step`` with the diversity tier
    inside it: no per-step host transfer.

Only ``for_lm`` builds an engine here; ``for_model_fns`` and the
evaluation hooks the reference's ``Trainer`` uses come with the paper's
small models (ROADMAP.md, Queue A 4).  The gram tier on the LM runs on a
hand-built engine: ``StepEngine(lambda n, tier: make_train_step(cfg, opt,
n, estimator=tier, probe_loss=..., probe_specs=...), lm_bucket_of(m))``.
There is no sharding and no elastic rung: the port runs on one device until
the scale-out slice, and ``as_dict()`` reports every rung as None.
"""

from __future__ import annotations

import dataclasses
import inspect
import time
from typing import Callable

from repro_torch.obs import metrics as metrics_lib
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


class EngineStats(metrics_lib.StatsView):
    """Observable engine behaviour, with the reference's ``as_dict()`` keys.

    ``compiles`` counts distinct step keys, one per (bucket, tier,
    batch-signature) tuple; ``bucket_hits`` / ``bucket_misses`` count
    lookups; ``buckets`` lists the bucket of each new key in order, and
    ``tiers`` its tier.  ``dispatch_wall_s`` is host time spent in ``step``:
    the step enqueues its device work and returns, so it is not end-to-end
    throughput.  The scalar fields are views over the ``repro_torch.obs``
    metrics registry (namespace ``train.engine.<n>``).
    """

    _COUNTERS = ("compiles", "bucket_hits", "bucket_misses", "steps", "reshards")
    _GAUGES = ("compile_s", "dispatch_wall_s")

    def __init__(self, *, registry: metrics_lib.Registry | None = None):
        self.buckets: list[int] = []
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
            "donate": True,
            "buckets": list(self.buckets),
            "rungs": [None] * len(self.buckets),
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


class StepEngine:
    """Bucketed step cache around ``make_train_step``.

    ``build_step(key)`` returns the step function of one bucket key;
    ``bucket_of(batch)`` maps a batch to its key.  ``build_step`` may
    instead take ``(key, tier)``: the engine is then tier-parameterised, and
    ``engine.tier`` (None until set; ``for_lm`` sets "moment") is passed to
    the build and keys the cache by (bucket, tier), so a flip back onto a
    seen tier is a hit.  As in the reference, setting ``tier`` on an engine
    whose build takes no tier raises at the next step.
    """

    def __init__(self, build_step: Callable[..., Callable],
                 bucket_of: Callable[[dict], int]):
        self._build = build_step
        self._bucket_of = bucket_of
        n_params = sum(1 for p in inspect.signature(build_step).parameters.values()
                       if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD))
        #: whether build_step takes the tier (see the class docstring)
        self.tiered = n_params >= 2
        #: the active estimator tier, part of every step key
        self.tier = None
        self._steps: dict[tuple, Callable] = {}
        self._keys: set[tuple] = set()
        self.stats = EngineStats()

    # -- step cache ------------------------------------------------------------
    def jitted(self, key: int) -> Callable:
        """The step function of bucket ``key`` at the active tier, built on
        first use (the reference's name for its not-yet-compiled jit)."""
        if self.tier is not None and not self.tiered:
            raise ValueError(
                "engine.tier was set but build_step takes no tier argument; "
                "tier flips on hand-built engines need a (key, tier) build")
        skey = (key, self.tier)
        if skey not in self._steps:
            self._steps[skey] = (self._build(key, self.tier) if self.tiered
                                 else self._build(key))
        return self._steps[skey]

    def _executable(self, key: int, batch: dict) -> Callable:
        sig = (key, self.tier, tuple(batch),
               tuple((tuple(v.shape[1:]), str(v.dtype)) for v in batch.values()))
        if sig in self._keys:
            self.stats.bucket_hits += 1
            return self.jitted(key)
        self.stats.bucket_misses += 1
        fn = self.jitted(key)
        self.stats.compiles += 1
        self.stats.buckets.append(key)
        self.stats.tiers.append(self.tier)
        self._keys.add(sig)
        return fn

    # -- stepping --------------------------------------------------------------
    def step(self, state: TrainState, batch: dict, lr) -> tuple[TrainState, dict]:
        """One optimizer step at whatever bucket ``batch`` lands on.  The
        state is updated in place (donated) and returned."""
        fn = self._executable(self._bucket_of(batch), batch)
        t0 = time.perf_counter()
        out = fn(state, batch, lr)
        self.stats.dispatch_wall_s += time.perf_counter() - t0
        self.stats.steps += 1
        return out

    # -- constructors ----------------------------------------------------------
    @classmethod
    def for_model_fns(cls, fns: ModelFns, optimizer: Optimizer, **kwargs) -> "StepEngine":
        """Engine over ``ModelFns`` (the paper's reference models)."""
        raise NotImplementedError(
            "StepEngine.for_model_fns (the paper's small models) is not ported "
            "to repro_torch yet (ROADMAP.md, Queue A 4)")

    @classmethod
    def for_lm(cls, cfg, optimizer: Optimizer, *, micro_batch: int | None = None,
               attn_impl: str | None = None) -> "StepEngine":
        """Engine over the transformer LM loss (the production path).

        One bucket is one ``num_micro`` (accumulation length): the bucket of
        a global batch of B sequences is ``B // micro_batch``.
        ``attn_impl`` overrides ``cfg.attn_impl`` for the training forward
        ("pallas" puts attention, forward and backward, on the kernels)."""
        if attn_impl is not None:
            cfg = cfg.replace(attn_impl=attn_impl)

        def build(num_micro: int, tier: str | None = None) -> Callable:
            return step_lib.make_train_step(
                cfg, optimizer, num_micro,
                **({"estimator": tier} if tier is not None else {}))

        eng = cls(build, lm_bucket_of(micro_batch))
        # name the default tier so a flip away and back lands on the warm key
        eng.tier = "moment"
        return eng
