"""Per-sample gradient squared norms of dense layers.

For a dense layer ``y = x @ W`` applied over a sequence, the per-sample
gradient is ``G_b = X_b^T Delta_b`` (Din, Dout), from the saved input
activation and the upstream output gradient (which the probe trick of
``models/probes.py`` delivers).  DiveBatch needs ``||G_b||_F^2``, never
``G_b`` itself.  Counterpart of ``repro/kernels/psgn.py``; wrappers over
hand-written CUDA kernels (built by ``_build.py``):

  psgn_direct  ||X^T D||_F^2 tile by tile, a loop over S inside each
               (Din, Dout) tile: x (B, S, Din), delta (B, S, Dout).
  psgn_gram    the same value as sum_{t,t'} (x_t . x_t')(d_t . d_t'), tile
               pairs of sequence positions, each contracting the full widths.
  psgn_fused   the sum over L stacked same-shape layers of psgn_direct, in
               one launch: x (L, B, S, Din), delta (L, B, S, Dout).
               :func:`psgn_fused_layers` takes the L layers as separate
               tensors instead, never stacking them on the card.

Each returns (B,) float32; inputs are float32 or bfloat16 (x and delta may
differ) and the products accumulate in float32.  The block keywords keep the
reference's signatures: they tile the TPU kernels, not these.

Three routes, chosen by :func:`plan` from dtypes and widths before any launch:

  tc     bf16 x and delta, Din and Dout multiples of 8 (TMA's 16-byte row
         stride): wgmma tensor-core kernels fed by TMA,
         ``csrc/psgn_direct_tc.cu`` (tiles 128 Din x 256 Dout) and
         ``csrc/psgn_gram_tc.cu`` (64 x 128 halves of 128 x 128 position
         pairs);
  split  a float32 operand, widths multiples of 8: :func:`psgn_split`
         (``csrc/psgn_split.cu``) splits each float32 operand into three
         bf16 terms, hi + mid + lo, and the same tensor-core kernels sum
         term products in one float32 accumulator per tile: direct and
         fused :func:`split_pairs`' 3 or 6 pairs of an x term and a delta
         term, gram for each operand's Gram :func:`gram_pairs`' 6 pairs of
         its own terms (1 for bf16), a set closed under swapping so the Gram
         stays symmetric.  Products of bf16 values are exact in float32, so
         this is the float32 result up to the order of the sums and the
         pairs left out (below 2^-21 of |x||d| or |v|^2 each).  The terms
         are scratch of the call;
  fma    a width not a multiple of 8: the float32 FMA kernels
         ``csrc/psgn_direct.cu`` and ``csrc/psgn_gram.cu`` (tiles 128 x
         128).

This is a dispatch between kernels decided up front, not a fallback: a
tensor-core or split launch that fails raises.  A tensor on the CPU goes to
the plain version (``kernels/ref.py``).  A tensor on the card goes to a
kernel, or the wrapper raises: a failed build, a refused launch, an
unsupported type or a card below sm_90 is an error, never a fall back to the
plain version.  Each wrapper counts its launches in ``.launches`` and, by
route, in ``.routes`` (``{"tc": n, "split": s, "fma": m}``); :func:`psgn_split`
counts its own launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.attention import _DTYPES, _check_cuda, _raise_on
from repro_torch.kernels.ref import gram_pairs

#: the FMA kernels' output tile (``kTile`` in ``csrc/psgn_tile.cuh``)
TILE = 128
#: the tensor-core direct kernel's (Din, Dout) tile (``psgn_direct_tc.cu``)
TC_DIRECT_TILE = (128, 256)
#: a tensor-core gram block: (rows, columns) of positions, half of a
#: TILE x TILE tile pair (``psgn_gram_tc.cu``)
TC_GRAM_TILE = (64, 128)


class Plan(NamedTuple):
    """How a call runs on the card: ``route`` "tc", "split" or "fma", the
    output ``tile`` of one block, ``n_partials``, the partial sums per sample
    the blocks write (the second pass adds them in a fixed order), and
    ``pairs``, the term products each tile sums (1 but on the split route):
    for gram a pair ``(x's Gram, delta's Gram)``."""
    route: str
    tile: tuple[int, int]
    n_partials: int
    pairs: int | tuple[int, int] = 1


def split_pairs(x_dtype: torch.dtype, d_dtype: torch.dtype) -> tuple[tuple[int, int], ...]:
    """The term pairs (i, j), x term i times delta term j, that the split
    route sums: terms 0, 1, 2 are hi, mid, lo of a float32 operand, a bf16
    operand has term 0 only.  With two float32 operands, the pairs with
    i + j <= 2 (mid.lo, lo.mid and lo.lo are left out)."""
    nx = 3 if x_dtype == torch.float32 else 1
    nd = 3 if d_dtype == torch.float32 else 1
    return tuple((i, j) for i in range(nx) for j in range(nd) if i + j <= 2)


def _tiles(n: int, tile: int = TILE) -> int:
    return -(-n // tile)


def plan(kind: str, x_dtype: torch.dtype, d_dtype: torch.dtype, s: int, d_in: int,
         d_out: int, n_layers: int = 1) -> Plan:
    """The route and tile plan of a ``kind`` ("direct", covering fused, or
    "gram") call on the card: tensor cores for bf16 x and delta whose widths
    are multiples of 8, the split route for a float32 operand at such
    widths, the FMA kernels otherwise."""
    widths8 = d_in % 8 == 0 and d_out % 8 == 0
    tc = x_dtype == d_dtype == torch.bfloat16 and widths8
    if kind == "gram":
        n_t = _tiles(s)
        tile_pairs = n_t * (n_t + 1) // 2
        if not widths8:
            return Plan("fma", (TILE, TILE), tile_pairs, (1, 1))
        return Plan("tc" if tc else "split", TC_GRAM_TILE, 2 * tile_pairs,
                    (len(gram_pairs(x_dtype)), len(gram_pairs(d_dtype))))
    if kind != "direct":
        raise ValueError(f"unknown kind {kind!r}")
    if widths8:
        ti, tj = TC_DIRECT_TILE
        n_partials = n_layers * _tiles(d_in, ti) * _tiles(d_out, tj)
        if tc:
            return Plan("tc", TC_DIRECT_TILE, n_partials)
        return Plan("split", TC_DIRECT_TILE, n_partials, len(split_pairs(x_dtype, d_dtype)))
    return Plan("fma", (TILE, TILE), n_layers * _tiles(d_in) * _tiles(d_out))


def _check_pair(name: str, x: torch.Tensor, delta: torch.Tensor, ndim: int) -> None:
    if x.dim() != ndim or delta.dim() != ndim or x.shape[:-1] != delta.shape[:-1]:
        raise ValueError(f"{name}: x {tuple(x.shape)} and delta {tuple(delta.shape)} "
                         f"must be {ndim}-D and agree on all but the last axis")
    if 0 in x.shape or 0 in delta.shape:
        raise ValueError(f"{name}: empty input {tuple(x.shape)}, {tuple(delta.shape)}")


def _check_card(name: str, tensors: dict[str, torch.Tensor]) -> None:
    x = next(iter(tensors.values()))
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no path for device {x.device}")
    for t in tensors.values():
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name}: dtype {t.dtype} has no kernel (float32, bfloat16)")
    _check_cuda(name, tensors, x.dtype)


def _outputs(x: torch.Tensor, b: int, n_partials: int) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.empty((b, n_partials), dtype=torch.float32, device=x.device),
            torch.empty((b,), dtype=torch.float32, device=x.device))


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _count(fn, route: str) -> None:
    fn.launches += 1
    fn.routes[route] += 1


def _fma_launch(lib_name: str, x: torch.Tensor, delta: torch.Tensor,
                dims: tuple[int, ...], n_partials: int) -> torch.Tensor:
    """The FMA kernel of library ``lib_name`` on (x, delta), whose batch axis
    is x's third from last; ``dims`` are the entry's shape arguments."""
    partials, out = _outputs(x, x.shape[-3], n_partials)
    lib = _build.library(lib_name)
    rc = getattr(lib, f"{lib_name}_fwd")(
        _DTYPES[x.dtype], _DTYPES[delta.dtype], x.data_ptr(), delta.data_ptr(),
        partials.data_ptr(), out.data_ptr(), *dims, n_partials, _stream(x))
    _raise_on(lib, lib_name, rc)
    return out


def psgn_split(xs: list[torch.Tensor]) -> torch.Tensor:
    """(3, L, *shape) bf16 terms hi, mid, lo of L float32 tensors of one
    shape, ``hi + mid + lo`` the value (:func:`ref.split_bf16`, bit for bit),
    in one launch (one per 64 tensors).  On the card the tensors are
    contiguous, 16-byte aligned and of a size that is a multiple of 8."""
    if not xs or any(t.dtype != torch.float32 or t.shape != xs[0].shape for t in xs):
        raise ValueError("psgn_split: needs float32 tensors of one shape")
    if xs[0].device.type == "cpu":
        return torch.stack([ref.split_bf16(t) for t in xs], 1)
    _check_card("psgn_split", {f"x[{i}]": t for i, t in enumerate(xs)})
    n = xs[0].numel()
    if n % 8 or n >= 2 ** 31:
        raise ValueError(f"psgn_split: {n} elements is not a multiple of 8 below 2**31")
    terms = torch.empty((3, len(xs), *xs[0].shape), dtype=torch.bfloat16, device=xs[0].device)
    ptrs = (ctypes.c_void_p * len(xs))(*[t.data_ptr() for t in xs])
    lib = _build.library("psgn_split")
    rc = lib.psgn_split_fwd(ctypes.addressof(ptrs), len(xs), n, terms.data_ptr(),
                            _stream(xs[0]))
    _raise_on(lib, "psgn_split", rc)
    psgn_split.launches += 1
    return terms


def _terms(ts: list[torch.Tensor]) -> list[list[torch.Tensor]]:
    """Per layer, the bf16 terms of ts[l]: the tensor itself when bf16, else
    its split (hi, mid, lo)."""
    if ts[0].dtype == torch.bfloat16:
        return [[t] for t in ts]
    terms = psgn_split(ts)
    return [[terms[k, i] for k in range(3)] for i in range(len(ts))]


def _direct(xs: list[torch.Tensor], ds: list[torch.Tensor],
            stacked: tuple[torch.Tensor, torch.Tensor] | None = None,
            ) -> tuple[torch.Tensor, str]:
    """``sum_l ||X_l^T D_l||^2`` over the layer tensors xs[l] (B, S, Din),
    ds[l] (B, S, Dout), validated and on the card; returns (out, route).
    The tensor-core and split routes take the layers as a table of pointers
    (on the split route, one entry per layer and term pair), the FMA route
    one (L, B, S, .) pair: ``stacked`` where the caller has it, else a
    stacked copy."""
    b, s, d_in = xs[0].shape
    d_out = ds[0].shape[-1]
    p = plan("direct", xs[0].dtype, ds[0].dtype, s, d_in, d_out, len(xs))
    if p.route == "fma":
        x, d = stacked if stacked is not None else (torch.stack(xs), torch.stack(ds))
        return _fma_launch("psgn_direct", x, d, (len(xs), b, s, d_in, d_out),
                           p.n_partials), p.route
    pairs = split_pairs(xs[0].dtype, ds[0].dtype)  # ((0, 0),) on the tc route
    x_terms, d_terms = _terms(xs), _terms(ds)
    partials, out = _outputs(xs[0], b, p.n_partials)
    n = len(xs) * len(pairs)
    x_ptrs = (ctypes.c_void_p * n)(*[x_terms[l][i].data_ptr()
                                     for l in range(len(xs)) for i, _ in pairs])
    d_ptrs = (ctypes.c_void_p * n)(*[d_terms[l][j].data_ptr()
                                     for l in range(len(xs)) for _, j in pairs])
    lib = _build.library("psgn_direct_tc")
    rc = lib.psgn_direct_tc_fwd(ctypes.addressof(x_ptrs), ctypes.addressof(d_ptrs), len(xs),
                                len(pairs), partials.data_ptr(), out.data_ptr(), b, s, d_in,
                                d_out, p.n_partials, _stream(xs[0]))
    _raise_on(lib, "psgn_direct_tc", rc)
    return out, p.route


def psgn_direct(x: torch.Tensor, delta: torch.Tensor, *, block_i: int = 128,
                block_j: int = 128, block_s: int = 512) -> torch.Tensor:
    """(B,) per-sample ``||X_b^T Delta_b||_F^2`` (float32).  x (B, S, Din),
    delta (B, S, Dout)."""
    _check_pair("psgn_direct", x, delta, 3)
    if x.device.type == "cpu":
        return ref.psgn_ref(x, delta)
    _check_card("psgn_direct", {"x": x, "delta": delta})
    out, route = _direct([x], [delta], (x[None], delta[None]))
    _count(psgn_direct, route)
    return out


def _gram_operand(v: torch.Tensor) -> tuple:
    """The gram kernel's arguments for one operand: its bf16 planes (``v``
    itself, or the split of a float32 ``v``) as a host array of pointers,
    their count, :func:`gram_pairs`' pairs as a host array of ints, their
    count; and what the host arrays point into, held until the call
    returns."""
    planes = _terms([v])[0]
    pairs = gram_pairs(v.dtype)
    ptrs = (ctypes.c_void_p * len(planes))(*[t.data_ptr() for t in planes])
    flat = (ctypes.c_int * (2 * len(pairs)))(*[i for pair in pairs for i in pair])
    return (ctypes.addressof(ptrs), len(planes), ctypes.addressof(flat), len(pairs)), \
        (planes, ptrs, flat)


def psgn_gram(x: torch.Tensor, delta: torch.Tensor, *, block_si: int = 256,
              block_sj: int = 256) -> torch.Tensor:
    """(B,) per-sample ``sum_{t,t'} (x_t . x_t')(d_t . d_t')``, equal to
    ``||X_b^T Delta_b||_F^2`` (float32).  x (B, S, Din), delta (B, S, Dout)."""
    _check_pair("psgn_gram", x, delta, 3)
    if x.device.type == "cpu":
        return ref.psgn_gram_ref(x, delta)
    _check_card("psgn_gram", {"x": x, "delta": delta})
    b, s, d_in = x.shape
    d_out = delta.shape[-1]
    p = plan("gram", x.dtype, delta.dtype, s, d_in, d_out)
    if p.route == "fma":
        out = _fma_launch("psgn_gram", x, delta, (b, s, d_in, d_out), p.n_partials)
    else:
        x_args, _x_held = _gram_operand(x)
        d_args, _d_held = _gram_operand(delta)
        partials, out = _outputs(x, b, p.n_partials)
        lib = _build.library("psgn_gram_tc")
        rc = lib.psgn_gram_tc_fwd(*x_args, *d_args, partials.data_ptr(), out.data_ptr(), b, s,
                                  d_in, d_out, p.n_partials, _stream(x))
        _raise_on(lib, "psgn_gram_tc", rc)
    _count(psgn_gram, p.route)
    return out


def psgn_fused(x: torch.Tensor, delta: torch.Tensor, *, block_i: int = 128,
               block_j: int = 128, block_s: int = 512) -> torch.Tensor:
    """(B,) sum over L stacked same-shape layers of per-sample
    ``||X^T D||_F^2``, in one launch.  x (L, B, S, Din), delta (L, B, S, Dout)."""
    _check_pair("psgn_fused", x, delta, 4)
    if x.device.type == "cpu":
        return ref.psgn_fused_ref(x, delta)
    _check_card("psgn_fused", {"x": x, "delta": delta})
    out, route = _direct(list(x.unbind(0)), list(delta.unbind(0)), (x, delta))
    _count(psgn_fused, route)
    return out


def psgn_fused_layers(xs: list[torch.Tensor], deltas: list[torch.Tensor]) -> torch.Tensor:
    """:func:`psgn_fused` over L same-shape layers given as separate tensors,
    xs[l] (B, S, Din) and deltas[l] (B, S, Dout): on the tensor-core route
    the kernel reads each layer where it lies (a table of TMA maps), so the
    group is never stacked on the card (the split route splits each float32
    layer in place); the FMA route stacks it.  On the CPU
    the layers are stacked into the plain version.  Counts as a
    ``psgn_fused`` launch."""
    if not xs or len(xs) != len(deltas):
        raise ValueError(f"psgn_fused_layers: {len(xs)} activations, {len(deltas)} deltas")
    for x, d in zip(xs, deltas):
        _check_pair("psgn_fused_layers", x, d, 3)
        if (x.shape, d.shape, x.dtype, d.dtype) != (xs[0].shape, deltas[0].shape,
                                                    xs[0].dtype, deltas[0].dtype):
            raise ValueError("psgn_fused_layers: the layers differ in shape or dtype")
    if xs[0].device.type == "cpu":
        return ref.psgn_fused_ref(torch.stack(xs), torch.stack(deltas))
    tensors = {f"x[{i}]": t for i, t in enumerate(xs)}
    tensors.update({f"delta[{i}]": t for i, t in enumerate(deltas)})
    _check_card("psgn_fused_layers", tensors)
    out, route = _direct(xs, deltas)
    _count(psgn_fused, route)
    return out


psgn_split.launches = 0
for _fn in (psgn_direct, psgn_gram, psgn_fused):
    _fn.launches = 0
    _fn.routes = {"tc": 0, "split": 0, "fma": 0}
