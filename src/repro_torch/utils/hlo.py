"""Cost model of a traced step of the port: FLOPs, HBM bytes, peak live
bytes and collectives per device, and the three-term roofline.

Counterpart of ``repro/utils/hlo.py``.  The reference parses the optimized
HLO of a compiled SPMD program.  The port has no HLO to parse: its program
is eager, a Python loop that dispatches one aten op at a time, and the same
program run on fake tensors (``FakeTensorMode``) on the host dispatches the
same ops, with the same shapes, without computing anything.
:class:`TraceCounter`, a ``TorchDispatchMode`` under the fake mode, watches
that stream on one rank:

  flops        ``torch.utils.flop_counter``'s formulas (2*M*N*K for every
               matmul, the convolutions), by op (``mm``, ``bmm``, ``addmm``,
               ...)
  hbm bytes    operand + result bytes of every aten op that moves data
               (views, allocations and metadata ops move none; a collective's
               bytes are its own).  An eager program
               has no fusion, so every op's operands and result cross HBM: a
               no-reuse model, with the reference's two slice rules
               (``_io_bytes``): an in-place update of a slice of a big buffer
               moves 2x the update, and an operand >= 32x the result is read
               as a slice, 2x the result.  ``hbm_bytes_adjusted`` leaves out
               the dtype conversions, the elementwise ops (aten's
               ``pointwise`` tag) and the fills, which a program with fusion
               folds into the op on either side (the reference's adjusted
               count leaves out conversions for the same reason): a lower
               bound on the traffic of the same work fused.  The roofline
               reads it, as the reference's does
  peak bytes   the bytes of the live storages, tallied as ops create them and
               weakref finalisers drop them, and their maximum
  collectives  per kind: count, operand bytes and ring-model time, reported
               by the port's own helpers (``dist.plan.record_collectives``),
               so they are the collectives the port issues.

The reference's trip-count propagation has no counterpart: a Python loop is
traced once per iteration.

Hardware model: one NVIDIA H100 SXM 80GB at its 700 W power limit, NVIDIA's
published data-sheet figures (dense rates, no sparsity): 989 TFLOP/s bf16
on the tensor cores, 80 GB of HBM3 at 3.35 TB/s, NVLink 900 GB/s to the
other cards of its host, 450 GB/s each way, 8 cards a host (DGX H100); across
hosts one 400 Gb/s InfiniBand NDR ConnectX-7 port per card (DGX H100 data
sheet), 50 GB/s each way.  A collective whose group lies within one host's 8
ranks (ranks ``8h .. 8h+7``) runs at the NVLink rate, any other at the
inter-host rate.  These are planning figures, not measurements.
"""

from __future__ import annotations

import collections
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.dist.plan import record_collectives

CARD = "NVIDIA H100 SXM 80GB"
POWER_LIMIT_W = 700
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
HBM_CAPACITY = 80e9
NVLINK_BW = 450e9
INTER_HOST_BW = 50e9
HOST_CARDS = 8

# the reference's kinds (the port issues no collective-permute), and the
# broadcast of ``dist.plan.broadcast_``
COLLECTIVE_KINDS = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute", "broadcast",
)

# fills: a program with fusion folds them into the op that first reads them
_FILLS = {"zeros", "zeros_like", "ones", "ones_like", "full", "full_like", "fill_", "zero_",
          "new_zeros", "new_full", "new_ones"}

# ops that allocate or relabel storage without reading or writing it
_NO_DATA = {
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "detach", "alias", "lift_fresh", "lift_fresh_copy", "set_", "resize_",
    "_local_scalar_dense", "is_same_size", "_unsafe_view",
}


#: the hardware model, as a plan's record carries it
HARDWARE = {"card": CARD, "power_limit_w": POWER_LIMIT_W, "peak_flops_bf16": PEAK_FLOPS,
            "hbm_bw": HBM_BW, "hbm_capacity": HBM_CAPACITY, "nvlink_bw": NVLINK_BW,
            "inter_host_bw": INTER_HOST_BW, "host_cards": HOST_CARDS,
            "source": "NVIDIA H100 and DGX H100 data sheets (published peaks), not measured"}


def link_bw(ranks) -> float:
    """The per-direction link rate of a group: NVLink when its ranks lie
    within one host, the inter-host link otherwise."""
    return NVLINK_BW if len({int(r) // HOST_CARDS for r in ranks}) <= 1 else INTER_HOST_BW


def _ring_time(kind: str, operand_bytes: int, result_bytes: int, n: int,
               link_bw: float = INTER_HOST_BW) -> float:
    n = max(n, 2)
    ring = (n - 1) / n
    if kind == "all-reduce":
        return 2.0 * ring * operand_bytes / link_bw
    if kind == "all-gather":
        return ring * max(result_bytes, operand_bytes) / link_bw
    if kind == "reduce-scatter":
        return ring * operand_bytes / link_bw
    if kind == "all-to-all":
        return ring * operand_bytes / link_bw
    return operand_bytes / link_bw  # collective-permute, broadcast


def _tensors(x) -> list[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    """The bytes an op reads of ``t``: its elements, or its storage's bytes
    when that is less (a broadcast view reads its data once)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


class TraceCounter(TorchDispatchMode):
    """Counts what the ops dispatched inside it cost on one device (the
    module docstring).  Enter it inside a ``FakeTensorMode`` to plan a
    program without running it; it counts real tensors as well.
    :meth:`snapshot` reads the running totals; :meth:`analysis` the
    reference's record."""

    def __init__(self):
        super().__init__()
        self.flops_by_op: collections.Counter = collections.Counter()
        self.hbm_bytes = 0.0
        self.convert_bytes = 0.0
        self.elementwise_bytes = 0.0
        self.live_bytes = 0
        self.peak_bytes = 0
        self.ops = 0
        self.collectives: dict[str, dict] = {}
        self._storages: dict[int, int] = {}
        self._recording = None

    def reset_counts(self) -> None:
        """Zero every additive count (flops, bytes, ops, collectives); the
        live storages and the peak stay: what was set up before the traced
        program is held but not counted as its work."""
        self.flops_by_op.clear()
        self.hbm_bytes = self.convert_bytes = self.elementwise_bytes = 0.0
        self.ops = 0
        self.collectives = {}

    # -- the mode ----------------------------------------------------------
    def __enter__(self):
        self._recording = record_collectives(self._collective)
        self._recording.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._recording.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.ops += 1
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops_by_op[packet.__name__] += flop_registry[packet](*args, **kwargs,
                                                                      out_val=out)
        outs = _tensors(out)
        if func.namespace == "aten":  # not the collectives (c10d) nor metadata (prim)
            io = self._io_bytes(func, _tensors(list(args) + list(kwargs.values())), outs)
            self.hbm_bytes += io
            if packet.__name__ == "_to_copy":
                self.convert_bytes += io
            elif torch.Tag.pointwise in func.tags or packet.__name__ in _FILLS:
                self.elementwise_bytes += io
        self._hold(outs)
        return out

    @staticmethod
    def _io_bytes(func, ins: list[torch.Tensor], outs: list[torch.Tensor]) -> float:
        """HBM traffic of one op (the module docstring)."""
        name = func._overloadpacket.__name__
        if func.is_view or name in _NO_DATA:
            return 0.0
        opers = [_nbytes(t) for t in ins]
        schema = func._schema
        mutated = bool(schema.arguments) and schema.arguments[0].alias_info is not None \
            and schema.arguments[0].alias_info.is_write
        if mutated and len(opers) > 1 and opers[0] >= 32 * max(opers[1:]):
            # an in-place update of a slice of a big buffer: 2x the update
            return 2.0 * sum(opers[1:])
        res = float(sum(_nbytes(t) for t in outs))
        io = res
        for b in opers:
            io += min(2.0 * res, b) if res > 0 and b >= 32 * res else b
        return io

    def _hold(self, tensors) -> None:
        """Tally the storages of ``tensors`` as live until they are freed."""
        for t in _tensors(tensors):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._storages:
                continue
            n = st.nbytes()
            self._storages[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._storages.pop(key, 0)

    def _collective(self, kind: str, operand: int, result: int, ranks) -> None:
        if kind not in COLLECTIVE_KINDS:
            raise ValueError(f"unknown collective kind {kind!r}")
        d = self.collectives.setdefault(kind, {"count": 0.0, "operand_bytes": 0.0,
                                               "time_s": 0.0})
        d["count"] += 1
        d["operand_bytes"] += operand
        d["time_s"] += _ring_time(kind, operand, result, len(ranks), link_bw(ranks))

    # -- results -----------------------------------------------------------
    def snapshot(self) -> dict:
        """The running totals (every count additive; ``peak_bytes`` the
        maximum so far)."""
        return {"flops_by_op": dict(self.flops_by_op), "hbm_bytes": self.hbm_bytes,
                "convert_bytes": self.convert_bytes,
                "elementwise_bytes": self.elementwise_bytes, "ops": self.ops,
                "peak_bytes": self.peak_bytes,
                "collectives": {k: dict(v) for k, v in self.collectives.items()}}

    def analysis(self, snap: dict | None = None) -> dict:
        """The reference's ``analyze()`` record of ``snap`` (default: the
        totals now): flops, HBM bytes and collectives per device."""
        snap = self.snapshot() if snap is None else snap
        coll = snap["collectives"]
        return {
            "flops": float(sum(snap["flops_by_op"].values())),
            "flops_by_op": dict(snap["flops_by_op"]),
            "hbm_bytes": snap["hbm_bytes"],
            "hbm_bytes_adjusted": (snap["hbm_bytes"] - snap["convert_bytes"]
                                   - snap["elementwise_bytes"]),
            "convert_bytes": snap["convert_bytes"],
            "elementwise_bytes": snap["elementwise_bytes"],
            "ops": snap["ops"],
            "peak_bytes": snap["peak_bytes"],
            "collectives": {
                "by_kind": coll,
                "total_operand_bytes": sum(d["operand_bytes"] for d in coll.values()),
                "total_time_s": sum(d["time_s"] for d in coll.values()),
            },
        }


def extrapolate(start: dict, micro: dict, end: dict, n: int) -> dict:
    """A step of ``n`` microbatches from the trace of a step of one:
    snapshots ``start`` (before the microbatch), ``micro`` (after it) and
    ``end`` (after the step).  Every count is ``end + (n - 1) * (micro -
    start)``: each microbatch dispatches the same ops.  The peak is the
    traced one (later microbatches hold what the first held)."""

    def lin(a, b, c):
        return c + (n - 1) * (b - a)

    ops = set(start["flops_by_op"]) | set(micro["flops_by_op"]) | set(end["flops_by_op"])
    kinds = set(start["collectives"]) | set(micro["collectives"]) | set(end["collectives"])
    zero = {"count": 0.0, "operand_bytes": 0.0, "time_s": 0.0}
    return {
        "flops_by_op": {k: lin(start["flops_by_op"].get(k, 0), micro["flops_by_op"].get(k, 0),
                               end["flops_by_op"].get(k, 0)) for k in ops},
        **{k: lin(start[k], micro[k], end[k])
           for k in ("hbm_bytes", "convert_bytes", "elementwise_bytes", "ops")},
        "peak_bytes": end["peak_bytes"],
        "collectives": {
            kind: {f: lin(start["collectives"].get(kind, zero)[f],
                          micro["collectives"].get(kind, zero)[f],
                          end["collectives"].get(kind, zero)[f]) for f in zero}
            for kind in kinds},
    }


def roofline_terms(flops: float, hbm_bytes: float, collective_time_s: float) -> dict:
    """Three roofline terms in seconds, PER DEVICE (inputs are per-device)."""
    compute_s = flops / PEAK_FLOPS
    memory_s = hbm_bytes / HBM_BW
    terms = {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_time_s,
    }
    dominant = max(terms, key=terms.get)
    terms["dominant"] = dominant
    terms["step_time_lower_bound_s"] = max(compute_s, memory_s, collective_time_s)
    return terms


def model_flops(n_params_active: float, tokens: float, kind: str = "train") -> float:
    """MODEL_FLOPS = 6*N*D (train) or 2*N*D (inference) — global, all chips."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_params_active * tokens
