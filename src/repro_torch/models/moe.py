"""Mixture-of-Experts FFN: top-k routing with a capacity-based grouped
product.

Counterpart of ``repro/models/moe.py``, the same function step for step:

  * tokens are processed in ``groups``; routing (top-k, the cumsum
    positions, the scatter) is group-local;
  * per group, each (token, expert) assignment goes to a slot of an
    ``(E, C, d)`` expert buffer, and the expert products run as batched
    products over the expert axis (``torch.einsum``; the reference runs them
    in XLA, on no Pallas kernel);
  * the capacity is ``C = int(T_g * top_k * capacity_factor / E) + 1``, at
    least 4; an assignment past its expert's capacity is dropped (weight 0,
    Switch-style).

Every token of a call counts toward ``C``: padding, a decode bucket's free
lanes and a microbatch's other sequences take slots like real tokens, as in
the reference.  So the port and the reference (or the card and the CPU)
agree only when both are handed the same padded batch.

Tensor-parallel (``tp``, a ``dist.sharding.TensorParallel``, the training
stack's on a tp plan): the experts hold the rank's ``ff/T`` columns; the
router is replicated and routes alike on every tp rank (so ``MoE.stats``
and the aux loss are equal across them), each rank runs the expert products
on its columns, and the combined output is summed over tp (``tp.exit``: an
all-reduce, or under a split residual a reduce-scatter to the rank's
``d/T`` columns).  The experts' input passes ``tp.enter`` and the combine
weights ``tp.copy`` (each rank's gradient there is its columns' part); the
routing's own use of the input has a gradient whole and alike on every
rank: with the residual whole it passes nothing, under a split residual
``tp.shared`` (divided by T, so that the entry's sum over tp counts it
once).

``MoE`` holds the parameters in the reference's layout: ``router`` a
bias-free ``nn.Linear(d, E)`` kept in float32 whatever the model's type,
``w_gate`` and ``w_up`` ``(E, d, f)``, ``w_out`` ``(E, f, d)``, so
``interop`` carries them without a rule of their own.  ``moe_reference``
computes the same function densely (every expert for every token) and is
the oracle of the tests and the card check; no path runs it.
"""

from __future__ import annotations

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.models.layers import ACTIVATIONS, in_func_transform


class MoE(nn.Module):
    """The MoE FFN of one layer.  ``stats``, when a dict, collects over
    ``moe_apply``'s calls the ``dropped`` assignments and ``first_top``,
    the tokens whose first expert is their group's commonest first expert
    (device scalars, never read back here), and ``assignments`` (an int);
    under remat the recomputed forward counts again, inside a ``torch.func``
    transform (the exact tier's per-sample pass) nothing counts."""

    def __init__(self, d_model: int, d_ff: int, num_experts: int, dtype: torch.dtype):
        super().__init__()
        self.router = nn.Linear(d_model, num_experts, bias=False, dtype=torch.float32)
        self.w_gate = nn.Parameter(torch.empty(num_experts, d_model, d_ff, dtype=dtype))
        self.w_up = nn.Parameter(torch.empty(num_experts, d_model, d_ff, dtype=dtype))
        self.w_out = nn.Parameter(torch.empty(num_experts, d_ff, d_model, dtype=dtype))
        self.stats: dict | None = None


@torch.no_grad()
def init_experts_(layer: MoE, generator: torch.Generator | None = None) -> None:
    """The reference's ``moe_init`` distributions for the expert tensors:
    ``w_gate``/``w_up`` N(0, 1/d), ``w_out`` N(0, 1/f) (the router is a
    dense layer: N(0, 1/d))."""
    d, f = layer.w_gate.shape[1:]
    for w, fan_in in ((layer.w_gate, d), (layer.w_up, d), (layer.w_out, f)):
        w.normal_(0.0, fan_in ** -0.5, generator=generator)


@torch.no_grad()
def init_moe(d_model: int, d_ff: int, num_experts: int, *,
             generator: torch.Generator | None = None,
             device: torch.device | str = "cuda", dtype: torch.dtype = torch.bfloat16
             ) -> MoE:
    """A standalone layer with random weights (``generator`` on ``device``)."""
    device = resolve_device(device)
    with torch.device("meta"):
        layer = MoE(d_model, d_ff, num_experts, dtype)
    layer = layer.to_empty(device=device).requires_grad_(False)
    layer.router.weight.normal_(0.0, d_model ** -0.5, generator=generator)
    init_experts_(layer, generator)
    return layer


def _top_k(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest in descending order, ties to the
    lower index (a stable descending sort; ``torch.topk`` leaves the order
    of ties unspecified)."""
    values, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _route(router_weight: torch.Tensor, x: torch.Tensor, top_k: int):
    """x (..., d) -> (weights (..., k) float32 renormalised, experts (..., k),
    the float32 router probabilities (..., E))."""
    logits = x.float() @ router_weight.float().t()
    probs = torch.softmax(logits, dim=-1)
    weights, experts = _top_k(probs, top_k)
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-9)
    return weights, experts, probs


def _capacity(tokens_per_group: int, top_k: int, num_experts: int, factor: float) -> int:
    c = int(tokens_per_group * top_k * factor / num_experts) + 1
    return max(c, 4)


def moe_apply(params: MoE, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, groups: int = 1, act: str = "silu",
              tp=None) -> tuple[torch.Tensor, torch.Tensor]:
    """``(output shaped like x, the load-balance aux loss)`` for x (B, S, d)
    or (T, d) in the compute type.

    Per group: route in float32; number each assignment within its expert
    by a one-hot cumsum over the token-major ``(T_g, k)`` assignments; keep
    those below ``C`` and park the rest at slot ``C - 1`` with zero input;
    scatter into the ``(E, C, d)`` buffer; run the SwiGLU expert products;
    gather each assignment's output, weight it and add a token's ``k``
    outputs in assignment order, in the compute type (the order of the
    reference's sequential scatter-add).  The aux loss is Switch's ``E *
    sum_e f_e p_e``, ``f_e`` from each token's first expert, averaged over
    the groups.  ``params.stats``, when a dict, gains the call's counts
    (``MoE``).  ``tp``: the experts are the rank's ``ff/T`` columns (the
    module docstring)."""
    shape = x.shape
    d = shape[-1]
    xt = x.reshape(-1, d)
    t = xt.shape[0]
    if t % groups:
        raise ValueError(f"{t} tokens do not split into {groups} MoE groups")
    tg = t // groups
    num_e = params.w_gate.shape[0]
    cap = _capacity(tg, top_k, num_e, capacity_factor)
    act_fn = ACTIVATIONS[act]
    dt = xt.dtype
    dev = xt.device

    xg = xt.reshape(groups, tg, d)
    weights, experts, probs = _route(params.router.weight,
                                     xg if tp is None else tp.shared(xg), top_k)  # (G, tg, k)
    e_flat = experts.reshape(groups, tg * top_k)
    w_flat = weights.reshape(groups, tg * top_k)
    experts_e = torch.arange(num_e, device=dev)
    # one-hot by comparison: F.one_hot reads its largest index, which vmap refuses
    oh = (e_flat[..., None] == experts_e).long()  # (G, tg*k, E)
    pos = ((oh.cumsum(dim=1) - 1) * oh).sum(-1)  # 0-based position within its expert
    keep = pos < cap
    slot = torch.where(keep, pos, cap - 1)
    token_idx = torch.arange(tg, device=dev).repeat_interleave(top_k)
    g_idx = torch.arange(groups, device=dev)[:, None].expand(groups, tg * top_k)
    if tp is not None:
        w_flat = tp.copy(w_flat)
    x_assign = (xg if tp is None else tp.enter(xg))[:, token_idx] * keep[..., None].to(dt)
    buf = torch.zeros((groups, num_e, cap, d), dtype=dt, device=dev).index_put(
        (g_idx, e_flat, slot), x_assign, accumulate=True)

    # load balance (Switch eq. 4): E * sum_e f_e * p_e, per group
    first = (experts[..., 0, None] == experts_e).long().sum(1)  # (G, E) tokens by first expert
    me = first.float() / tg
    aux = num_e * (me * probs.mean(1)).sum(-1)
    stats = params.stats
    if stats is not None and not in_func_transform():  # the per-sample pass counts nothing
        stats["dropped"] = stats.get("dropped", 0) + (~keep).sum()
        stats["first_top"] = stats.get("first_top", 0) + first.amax(-1).sum()
        stats["assignments"] = stats.get("assignments", 0) + t * top_k

    h = act_fn(torch.einsum("gecd,edf->gecf", buf, params.w_gate.to(dt)))
    h = h * torch.einsum("gecd,edf->gecf", buf, params.w_up.to(dt))
    out_buf = torch.einsum("gecf,efd->gecd", h, params.w_out.to(dt))

    y_assign = out_buf[g_idx, e_flat, slot] * (w_flat * keep).to(dt)[..., None]
    y_assign = y_assign.reshape(groups, tg, top_k, d)
    y = y_assign[:, :, 0]
    for j in range(1, top_k):
        y = y + y_assign[:, :, j]
    y = y.reshape(shape)
    return (y if tp is None else tp.exit(y)), aux.mean()


def moe_reference(params: MoE, x: torch.Tensor, *, top_k: int, act: str = "silu"
                  ) -> torch.Tensor:
    """Dense oracle: every expert for every token, then the top-k mix.  No
    capacity: it equals ``moe_apply`` only where nothing is dropped."""
    shape = x.shape
    d = shape[-1]
    xt = x.reshape(-1, d)
    dt = xt.dtype
    weights, experts, _ = _route(params.router.weight, xt, top_k)
    act_fn = ACTIVATIONS[act]
    h = act_fn(torch.einsum("td,edf->tef", xt, params.w_gate.to(dt)))
    h = h * torch.einsum("td,edf->tef", xt, params.w_up.to(dt))
    y_all = torch.einsum("tef,efd->ted", h, params.w_out.to(dt))  # (T, E, d)
    sel = y_all.gather(1, experts[..., None].expand(-1, -1, d))  # (T, k, d)
    y = (sel * weights[..., None].to(dt)).sum(1)
    return y.reshape(shape)
