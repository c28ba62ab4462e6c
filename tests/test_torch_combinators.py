"""The port's policy combinators against the JAX reference's.

``repro_torch.adapt.combinators`` is a copy of pure Python over ``Signals``
and ``Decision``, so the same signal sequences must give the same
decisions, field for field, and the same ``state_dict``.  Sequences come
from numpy with a seed: diversity, gradient-noise scale and the diversity
bound (with missing, non-finite and zero bounds mixed in), at epoch
boundaries and ticks.  The ``Hysteresis`` no-flap property of
``tests/test_adapt.py`` is checked on the port, through
``tests/_hypothesis_compat.py``.
"""

import dataclasses
import types

import numpy as np
import pytest
from _hypothesis_compat import given, settings, strategies as st

from repro import adapt as J
from repro.core.batch_policy import bucket as jbucket
from repro_torch import adapt as T
from repro_torch.core.batch_policy import bucket

N = 16_000


def _ladder():
    """A duck-typed ladder: rungs of dp 1, 2, 4, 8 (both packages read only
    ``rungs[i].dp`` and ``.index``)."""
    rungs = [types.SimpleNamespace(index=i, dp=2 ** i) for i in range(4)]
    return types.SimpleNamespace(rungs=rungs)


class _RungStub:
    """Inner policy deciding an explicit rung and a raw batch each call."""

    def __init__(self, pkg, seq):
        self.pkg, self.seq, self.i, self.m = pkg, seq, 0, 64
        self.needs_diversity = True
        self.max_buckets = 1

    def fires(self, clock):
        return True

    def observe(self, signals, clock):
        rung, m = self.seq[self.i % len(self.seq)]
        self.i += 1
        self.m = m
        return self.pkg.Decision(batch_size=m, rung=rung, reason="stub")

    @property
    def batch_size(self):
        return self.m

    def set_batch_size(self, m):
        self.m = int(m)

    def state_dict(self):
        return {"m": self.m, "i": self.i}

    def load_state_dict(self, state):
        self.m, self.i = state["m"], state["i"]


def _divebatch(pkg, **kw):
    return pkg.DiveBatchPolicy(64, 4096, 0.05, dataset_size=N, granule=16, on_tick=True,
                               **kw)


BUILDERS = {
    "clamped": lambda pkg: pkg.Clamped(_divebatch(pkg), m_min=32, m_max=512),
    "bounded": lambda pkg: pkg.BoundedRung(_divebatch(pkg), granule=16, margin=0.5),
    "bounded-rung": lambda pkg: pkg.BoundedRung(
        _RungStub(pkg, [(3, 512), (1, 64), (2, 4096), (0, 16)]), granule=16,
        ladder=_ladder()),
    "warmup": lambda pkg: pkg.Warmup(_divebatch(pkg), epochs=2, steps=30),
    "hysteresis": lambda pkg: pkg.Hysteresis(_divebatch(pkg), band=0.1),
    "chain": lambda pkg: pkg.Chain(
        pkg.Clamped(_divebatch(pkg), m_max=1024),
        pkg.GradNoisePolicy(64, 4096, granule=16, alpha=0.5)),
    "switch": lambda pkg: pkg.Switch.at_epochs(
        [2, 4], [pkg.FixedPolicy(64, granule=16), _divebatch(pkg),
                 pkg.AdaBatchPolicy(64, 4096, resize_freq=1, granule=16)]),
    "nested": lambda pkg: pkg.Hysteresis(
        pkg.Warmup(pkg.Clamped(_divebatch(pkg), m_min=64), steps=20), band=0.2),
}


def _sequence(seed, n=40):
    """``(signals fields, clock fields)`` pairs: three ticks per epoch."""
    rng = np.random.default_rng(seed)
    out, step = [], 0
    for i in range(n):
        step += int(rng.integers(1, 20))
        boundary = "epoch" if i % 4 == 3 else "tick"
        div = float(rng.uniform(1e-3, 0.5))
        samples = float(rng.integers(100, N))
        bound = [samples * div, None, float("nan"), 0.0, float("inf")][
            int(rng.integers(0, 5)) if i % 3 == 0 else 0]
        sig = dict(diversity=div, gns=float(rng.uniform(1.0, 5000.0)), samples=samples,
                   loss=float(rng.uniform(0.1, 1.0)), batch_size=64,
                   diversity_bound=bound)
        out.append((sig, dict(epoch=i // 4, step=step, boundary=boundary)))
    return out


@pytest.mark.parametrize("name", list(BUILDERS))
@pytest.mark.parametrize("seed", [0, 1])
def test_same_signals_give_the_same_decisions(name, seed):
    theirs, ours = BUILDERS[name](J), BUILDERS[name](T)
    n_decided = 0
    for sig, clock in _sequence(seed):
        jc, tc = J.Clock(**clock), T.Clock(**clock)
        assert theirs.fires(jc) == ours.fires(tc)
        if not ours.fires(tc):
            continue
        a = theirs.observe(J.Signals(**sig), jc)
        b = ours.observe(T.Signals(**sig), tc)
        assert (a is None) == (b is None), (clock, a, b)
        if a is not None:
            n_decided += 1
            assert dataclasses.astuple(a) == dataclasses.astuple(b)
        assert theirs.batch_size == ours.batch_size
    assert n_decided > 0
    assert ours.state_dict() == theirs.state_dict()
    assert ours.needs_diversity == theirs.needs_diversity
    assert ours.max_buckets == theirs.max_buckets
    # a state dict written by either package loads in the other
    again = BUILDERS[name](T)
    again.load_state_dict(theirs.state_dict())
    assert again.state_dict() == theirs.state_dict()


def test_programs_with_combinators_checkpoint_alike():
    """An ``AdaptationProgram`` over a combinator writes the reference's
    schema-v2 state dict and loads the reference's."""
    def program(pkg):
        return pkg.AdaptationProgram(BUILDERS["nested"](pkg), 0.5, estimator="moment",
                                     tick_every=4)

    theirs, ours = program(J), program(T)
    for sig, clock in _sequence(3, 24):
        theirs.observe(J.Signals(**sig), J.Clock(**clock))
        ours.observe(T.Signals(**sig), T.Clock(**clock))
    assert ours.state_dict() == theirs.state_dict()
    fresh = program(T)
    fresh.load_state_dict(theirs.state_dict())
    assert fresh.state_dict() == theirs.state_dict()
    assert (fresh.batch_size, fresh.lr) == (theirs.batch_size, theirs.lr)


class _RawStub:
    """Inner policy emitting a pre-set raw target each observation."""

    def __init__(self, pkg, bucket_fn, m0=64, granule=16, m_max=8192):
        self.pkg, self.bucket = pkg, bucket_fn
        self.m, self.granule, self.m_max = m0, granule, m_max
        self.next_raw = float(m0)
        self.needs_diversity = False

    def fires(self, clock):
        return True

    def observe(self, signals, clock):
        self.m = self.bucket(int(max(self.next_raw, 1)), self.granule, m_max=self.m_max)
        return self.pkg.Decision(batch_size=self.m, raw_batch_size=self.next_raw)

    @property
    def batch_size(self):
        return self.m

    def set_batch_size(self, m):
        self.m = int(m)

    def state_dict(self):
        return {"m": self.m}

    def load_state_dict(self, state):
        self.m = int(state["m"])


@given(
    r0=st.floats(20.0, 4000.0),
    band=st.sampled_from([0.05, 0.1, 0.2]),
    seed=st.integers(0, 10_000),
)
@settings(max_examples=60, deadline=None)
def test_hysteresis_never_flaps_within_band(r0, band, seed):
    """For any raw walk whose consecutive ratio stays within [1/(1+band),
    1+band], the port's held schedule never goes A -> B -> A, and it is the
    reference's schedule."""
    rng = np.random.default_rng(seed)
    ours = T.Hysteresis(_RawStub(T, bucket), band=band)
    theirs = J.Hysteresis(_RawStub(J, jbucket), band=band)
    held, held_ref, r = [], [], float(r0)
    for _ in range(60):
        ours.inner.next_raw = theirs.inner.next_raw = r
        held.append(ours.observe(T.Signals(), T.Clock(0, 0, "tick")).batch_size)
        held_ref.append(theirs.observe(J.Signals(), J.Clock(0, 0, "tick")).batch_size)
        r *= float(rng.uniform(1.0 / (1.0 + band), 1.0 + band))
    assert held == held_ref
    for a, b, c in zip(held, held[1:], held[2:]):
        assert not (b != a and c == a), (a, b, c, held)
