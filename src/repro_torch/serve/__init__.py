"""repro_torch.serve — continuous-batching serving over a paged KV cache.

Counterpart of ``repro.serve``: ``ServeEngine`` (engine.py) drives the
``Scheduler`` (scheduler.py), the ``BlockPool`` host accounting (blocks.py)
and a ``ServePolicy`` (policy.py) over the port's model, with chunked
prefill and paged decode running through the hand-written kernels.  The
scheduler, pool and policies are exact copies of the reference's, so the
two engines make the same decisions on the same requests.
"""

from repro_torch.serve.blocks import BlockPool, PoolExhausted, chain_keys
from repro_torch.serve.engine import ServeEngine, ServeStats, padded_prompt_len
from repro_torch.serve.policy import (
    POLICIES,
    FairSharePolicy,
    FifoPolicy,
    PriorityPolicy,
    QueuedRequest,
    ServeDecision,
    ServePolicy,
    ServeSignals,
    make_serve_policy,
)
from repro_torch.serve.scheduler import (
    FREE_RID,
    Admission,
    Request,
    Result,
    Scheduler,
    slots_for,
)

__all__ = [
    "ServeEngine",
    "ServeStats",
    "Scheduler",
    "Admission",
    "Request",
    "Result",
    "BlockPool",
    "PoolExhausted",
    "chain_keys",
    "padded_prompt_len",
    "slots_for",
    "FREE_RID",
    "ServePolicy",
    "ServeSignals",
    "ServeDecision",
    "QueuedRequest",
    "FifoPolicy",
    "PriorityPolicy",
    "FairSharePolicy",
    "make_serve_policy",
    "POLICIES",
]
