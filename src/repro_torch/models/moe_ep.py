"""Expert-parallel MoE with an explicit all-to-all.

Counterpart of ``repro/models/moe_ep.py``, function for function.  Under
``cfg.moe_impl == "ep"`` on a rank plan whose expert axes span several
ranks, each rank keeps its ``E / ep`` experts (the sharded state's expert
shard, ``dist.sharding.StateLayout.ep_resident``) and the tokens travel to
them and back; routing is shard-local.  Per rank (``T`` local tokens, ``A``
the expert ranks):

  1. route top-k in float32; an assignment's destination is ``expert //
     E_local``;
  2. scatter the assignments into per-destination send buffers ``(A, CAP,
     d)``, ``CAP = max(int(T * k * cf / A) + 1, 4)``; an assignment past its
     destination's capacity drops (Switch-style);
  3. exchange (``dist.plan.all_to_all``, whose backward is the reverse
     exchange): row ``a`` now holds what rank ``a`` sent here, with its
     local expert ids;
  4. dispatch the received rows to ``(E_local, C2, d)``, ``C2 = max(int(2
     * A * CAP / E_local) + 1, 4)``, and run the SwiGLU products on the
     resident experts;
  5. read each received row's output back, exchange back, and add a
     token's ``k`` weighted outputs in assignment order.

The reference splits the experts' ff dim over tp and sums the ``w_out``
contraction with a ``psum``; here a block's gather makes the ff dim whole
(``dist.sharding.gathered`` leaves only the expert dim resident), so the
products run whole on every tp rank.  The aux loss is Switch's ``E * sum_e
f_e p_e`` over the rank's tokens, averaged over the expert ranks (its
backward averages the cotangents the same way).  Numbers equal
``moe.moe_reference`` when nothing drops; what drops depends on the ranks'
token counts, so a comparison at a capacity that drops uses the
reference's mesh shape.  One-hot masks are comparisons (as in
``moe.py``): ``F.one_hot`` reads its largest index.

Expert weights may also come whole (a state that keeps whole leaves): each
rank then computes with its own block of experts, and the data-parallel
mean of the gradients adds the blocks' contributions.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.dist.plan import all_reduce_mean, all_to_all, all_to_all_dim0
from repro_torch.models.layers import ACTIVATIONS, in_func_transform
from repro_torch.models.moe import MoE, _route


def _positions_within(dest: torch.Tensor, num_dest: int) -> torch.Tensor:
    """0-based arrival order of each assignment at its destination bucket."""
    oh = (dest[:, None] == torch.arange(num_dest, device=dest.device)).long()  # (N, A)
    return ((oh.cumsum(dim=0) - 1) * oh).sum(-1)


class _GroupMean(torch.autograd.Function):
    """A scalar averaged over a group; its backward averages the
    cotangents over the same group (each rank's loss reads the mean)."""

    @staticmethod
    def forward(ctx, x, group, n):
        ctx.group, ctx.n = group, n
        return all_reduce_mean([x.detach().clone()], group, n)[0]

    @staticmethod
    def backward(ctx, g):
        return all_reduce_mean([g.contiguous()], ctx.group, ctx.n)[0], None, None


def _capacity(tokens: int, top_k: int, dest: int, factor: float) -> int:
    return max(int(tokens * top_k * factor / dest) + 1, 4)


def moe_apply_ep(params: MoE, x: torch.Tensor, *, top_k: int, capacity_factor: float,
                 act: str, mesh, ep_axes) -> tuple[torch.Tensor, torch.Tensor]:
    """``(y shaped like x, aux)`` for this rank's tokens x (B, S, d), its
    experts resident (``w_gate`` of ``E / ep`` experts) or whole.
    ``ep_axes`` are the plan's expert axes on ``mesh``.  ``params.stats``,
    when a dict, gains ``dropped`` (this rank's assignments dropped at
    either capacity) and ``assignments``."""
    group, n_ep, _ = mesh.axis_group(ep_axes)
    e_total = params.router.weight.shape[0]
    if e_total % n_ep:
        raise ValueError(f"{e_total} experts do not split over {n_ep} expert ranks")
    e_loc = e_total // n_ep
    w_gate, w_up, w_out = params.w_gate, params.w_up, params.w_out
    if w_gate.shape[0] == e_total:  # whole experts: this rank's block
        c = mesh.coords()
        k = 0
        for a in ((ep_axes,) if isinstance(ep_axes, str) else ep_axes):
            k = k * mesh.shape[a] + c[a]
        w_gate, w_up, w_out = (w[k * e_loc:(k + 1) * e_loc] for w in (w_gate, w_up, w_out))
    elif w_gate.shape[0] != e_loc:
        raise ValueError(f"expert weights of {w_gate.shape[0]} experts, neither {e_total} "
                         f"nor the {e_loc} of one of {n_ep} expert ranks")
    act_fn = ACTIVATIONS[act]
    shape = x.shape
    d = shape[-1]
    xt = x.reshape(-1, d)
    t = xt.shape[0]
    dt, dev = xt.dtype, xt.device

    # 1. route (float32 router math)
    weights, experts, probs = _route(params.router.weight, xt, top_k)
    n = t * top_k
    e_flat = experts.reshape(n)
    w_flat = weights.reshape(n)
    token_idx = torch.arange(t, device=dev).repeat_interleave(top_k)
    dest = torch.div(e_flat, e_loc, rounding_mode="floor")
    e_local_id = e_flat - dest * e_loc

    cap = _capacity(t, top_k, n_ep, capacity_factor)
    pos = _positions_within(dest, n_ep)
    keep = pos < cap
    # dropped assignments land in a spare row that is cut off (mode="drop")
    row = torch.where(keep, dest, n_ep)
    col = torch.where(keep, pos, 0)
    send_x = torch.zeros((n_ep + 1, cap, d), dtype=dt, device=dev).index_put(
        (row, col), xt[token_idx], accumulate=True)[:n_ep]
    send_e = torch.full((n_ep + 1, cap), -1, dtype=torch.int64, device=dev).index_put(
        (row, col), e_local_id)[:n_ep]

    # 2. exchange: slot [a] <- what rank a sent here
    recv_x = all_to_all(send_x.contiguous(), mesh, ep_axes).reshape(n_ep * cap, d)
    recv_e = all_to_all_dim0(send_e.contiguous(), mesh, ep_axes).reshape(n_ep * cap)

    # 3. local capacity dispatch to (E_loc, C2, d)
    t2 = n_ep * cap
    c2 = _capacity(t2, 1, e_loc, 2.0)
    valid = recv_e >= 0
    e_safe = torch.where(valid, recv_e, 0)
    pos2 = _positions_within(torch.where(valid, recv_e, e_loc), e_loc + 1)
    keep2 = valid & (pos2 < c2)
    row2 = torch.where(keep2, e_safe, e_loc)
    col2 = torch.where(keep2, pos2, 0)
    buf = torch.zeros((e_loc + 1, c2, d), dtype=dt, device=dev).index_put(
        (row2, col2), recv_x, accumulate=True)[:e_loc]

    # 4. the products on the resident experts
    h = act_fn(torch.einsum("ecd,edf->ecf", buf, w_gate.to(dt)))
    h = h * torch.einsum("ecd,edf->ecf", buf, w_up.to(dt))
    y_buf = torch.einsum("ecf,efd->ecd", h, w_out.to(dt))

    # 5. read back per received slot, exchange back, weighted combine
    y_recv = y_buf[torch.where(keep2, row2, 0), col2] * keep2[:, None].to(dt)
    back = all_to_all(y_recv.reshape(n_ep, cap, d).contiguous(), mesh, ep_axes)
    y_assign = back[torch.where(keep, row, 0), col] * (w_flat * keep).to(dt)[:, None]
    y_assign = y_assign.reshape(t, top_k, d)
    y = y_assign[:, 0]
    for j in range(1, top_k):
        y = y + y_assign[:, j]

    # aux load balance over this rank's tokens, averaged over the expert ranks
    me = (experts[:, 0, None] == torch.arange(e_total, device=dev)).float().mean(0)
    aux = e_total * (me * probs.mean(0)).sum()
    aux = _GroupMean.apply(aux, group, n_ep) if n_ep > 1 else aux
    stats = params.stats
    if stats is not None and not in_func_transform():
        stats["dropped"] = stats.get("dropped", 0) + (~keep).sum() + (valid & ~keep2).sum()
        stats["assignments"] = stats.get("assignments", 0) + n
    return y.reshape(shape), aux


def expert_parallel(plan) -> bool:
    """Whether ``plan`` routes ``moe_impl="ep"`` FFNs over an explicit
    all-to-all: a rank plan whose expert axes span several ranks."""
    return (plan is not None and getattr(plan.mesh, "ranked", False)
            and dist.is_initialized() and plan.ep_size > 1)
