"""repro_torch.adapt: signal-driven training adaptation (a copy of the
reference's ``repro.adapt`` over the port's train state).

A policy observes :class:`Signals` (diversity estimate, gradient-noise
scale, loss, throughput, events) at :class:`Clock` boundaries and emits
typed :class:`Decision` records; combinators (``Clamped``, ``BoundedRung``,
``Warmup``, ``Hysteresis``, ``Chain``, ``Switch``) wrap policies, and
``AdaptationProgram`` drives a policy against the clock with an
:class:`LrCoupling`.  ``ThroughputWindow`` also
feeds the serving stats.
"""

from repro_torch.adapt.combinators import (
    BoundedRung,
    Chain,
    Clamped,
    Hysteresis,
    LrCoupling,
    Switch,
    Warmup,
)
from repro_torch.adapt.policy import (
    AdaBatchPolicy,
    AdaptationPolicy,
    Decision,
    DiveBatchPolicy,
    FixedPolicy,
    FromBatchPolicy,
    GradNoisePolicy,
    PolicyBase,
)
from repro_torch.adapt.program import SCHEMA_VERSION, AdaptationProgram, Applied
from repro_torch.adapt.signals import (
    Clock,
    Signals,
    ThroughputWindow,
    gns_from_accumulators,
    read_signals,
)

__all__ = [
    "Clock",
    "Signals",
    "ThroughputWindow",
    "read_signals",
    "gns_from_accumulators",
    "Decision",
    "AdaptationPolicy",
    "PolicyBase",
    "FromBatchPolicy",
    "FixedPolicy",
    "AdaBatchPolicy",
    "DiveBatchPolicy",
    "GradNoisePolicy",
    "LrCoupling",
    "Clamped",
    "BoundedRung",
    "Warmup",
    "Hysteresis",
    "Chain",
    "Switch",
    "AdaptationProgram",
    "Applied",
    "SCHEMA_VERSION",
]
