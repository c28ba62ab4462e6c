"""Smoke run of the PyTorch/CUDA port on one Hopper card.

  python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

  1. the card: a CUDA device must exist; prints its name and power limit;
  2. build: compiles every kernel of ``src/repro_torch/kernels/csrc`` with
     nvcc for sm_90a (one nvcc per source, all at once), prints build seconds
     and the ptxas register / shared-memory lines;
  3. kernels against their plain versions on the card (TF32 off): chunk
     attention at the serving shape (Yi-6B heads 32/4, hd 128, bf16, a
     256-token chunk over 768 prior tokens in a sentinel-padded 64-block
     prior table) and at small edge cases (float32 and bf16, softcap,
     window, ragged C and Sk, padded query rows at -(2**30), n_rep 1 and 8);
     paged decode at B=8, block 16, ragged lengths, dead table entries at 0,
     out-of-order pool ids, split over the context by ``decode_plan`` (9
     splits at the serving shape; its edges: lengths 1 and one block, a
     split boundary and one token either side, a full table, free lanes
     whose tables are all sentinel), and 20 launches giving the same bits.
     bf16 is held at 2e-2 against the plain version
     in float32 on the same bf16 inputs, float32 at 1e-4.  Times: kernel,
     plain version and the library yardstick
     (``F.scaled_dot_product_attention``, timed here only), each launch
     timed with CUDA events after a 64 MiB L2 flush;
  4. the slice at full width: Yi-6B with all 32 layers in bf16, weights from
     a seeded generator, served through ``repro_torch.serve.ServeEngine``
     (8 slots, max_seq 2048, block 16, prefill chunk 256, prefix sharing on)
     on 8 greedy requests of 64-700 prompt tokens, two sharing a 256-token
     prefix, 32 new tokens each.  The kernel launch counts are set to 0 just
     before and read just after, and must equal 32 per decode step and 32
     per prefill chunk;
  5. the card against the CPU: a reduced Yi-6B (4 layers, float32) with
     identical weights serves the same greedy trace on the card (kernels)
     and on the CPU (plain versions): identical tokens, first logits within
     1e-4;
  6. the training slice: Yi-6B widths at 8 of its 32 layers in bf16 with
     per-layer remat, weights from a seeded generator, trained 12 steps
     through ``repro_torch.train.StepEngine.for_lm`` (sgd with momentum 0.9,
     micro batch 2, sequences of 2048 tokens from ``TokenStream``,
     ``attn_impl="pallas"``) under a tick-fired DiveBatch program (m0 4,
     m_max 16, granule 2, a tick every 4 steps).  Every loss must be
     finite, and the launch counts, set to 0 just before and read just
     after, must be exactly 16 chunk-attention (forward, and again under
     remat), 8 flash-dq and 8 flash-dk/dv launches per microbatch;
  7. training on the card against the CPU: a reduced float32 Yi-6B (hd 64)
     with identical weights trains 6 steps with a DiveBatch program (a tick
     every 2 steps) on the card (kernels) and on the CPU (plain versions):
     losses within 1e-4 relative, parameters within 1e-4 absolute, the same
     batch schedule and num_micro buckets;
  8. the gram tier: phase 6's model and cut (``attn_impl="pallas"``) trained
     8 steps through a hand-built tiered ``StepEngine`` (``estimator=
     "gram"``, probes from ``repro_torch.models.probes``) under a DiveBatch
     program reading the gram signals (m0 4, m_max 8, delta 2, a tick every
     4 steps), which must resize once.  Launches per microbatch exactly 16
     chunk, 8 dq, 8 dk/dv, 2 psgn_fused (the q/o and the k/v groups), 24
     psgn_gram (gate, up, down) and no psgn_direct, every psgn launch on
     the tensor-core route.  Then one microbatch timed in parts (main pass,
     probe pass, psgn kernels), and ``probes.persample_sq_norms_gram`` on
     it (timed, with its peak memory): 32 psgn_direct launches on the split
     route (its deltas are float32) with 32 psgn_split launches, and 24
     psgn_gram on the FMA route, its (B,) result within 1e-4 relative of
     the tree's (the routes against each other, on the card);
  9. the gram tier on the card against the CPU: a reduced float32 Yi-6B (hd
     64, d_ff 1024, S 128, where every layer takes the dispatch Yi-6B takes
     at S 2048) trains 5 steps (a tick every 2): losses, Delta at the ticks
     and ``sq_norm_sum`` within 1e-4 relative, parameters within 1e-4, one
     batch schedule; every psgn_fused launch on the split route (x and
     delta split once each).

The chunk forward, dq and dk/dv have two routes (``kattn.attention_plan``):
bf16 at head dims 64 and 128 takes the tensor-core kernels
(``chunk_attention_tc.cu``, ``flash_dq_tc.cu``, ``flash_dkv_tc.cu``), float32
and hd 32 the FMA kernels.  Phase 3 holds both against the plain versions
and prints each case's route in brackets (``[tc]``, ``[fma]``; ``[dq, dk/dv
tc]`` for the backward), with the key tiles the tensor-core forward visited
out of all, as its blocks counted them on the card (it skips tiles by
position); its tensor-core cases add ragged C and S, C < 64, n_rep 1, 4 and
8, hd 64 and 128, softcap, a window across tiles, padded rows, a live row
with no attendable key, a sentinel-only prior tail,
shuffled keys at positions past the array bounds, 128-row blocks, the
serving shape and the training shape; the backward's add S 1, 63, 64, 65,
129 and 300 at hd 64 and 128 with n_rep 1, 2 and 8, a window across tiles
and softcap 20.  Phases 4, 6 and 8 assert that every chunk, dq and dk/dv
launch took the tensor cores, phases 5, 7 and 9 (float32) the FMA kernels.

Phase 3 also holds the flash-attention backward kernels (dq, dk/dv) against
their plain version: float32 edge cases (ragged S 37 and 300, n_rep 1 and
8, softcap, window, a single tile) at 1e-4, the same in bf16, and the
training shape (B 2, S 2048, Yi-6B heads, bf16), timed beside the plain
version and the backward of ``F.scaled_dot_product_attention``.  Their
outputs are float32 from bf16 inputs, rounded at the same points as the
plain version, so the bf16 cases are held at 2e-3 absolute (no relative
term), a tenth of a typical dq at S 2048; each case prints the RMS of the
plain dq, dk and dv beside its error.

Phase 3 also holds the per-sample gradient-norm kernels (psgn direct, gram
and fused over 3 layers) against their plain versions: float32, bf16 and
bf16 activations with float32 deltas, ragged S and widths, a single
position, tile edges (the FMA route), bf16 at widths that are multiples of
8 (the tensor-core route, S up to 2049, widths up to 4104), and the same
widths with a float32 operand, bf16 x f32, f32 x bf16 and f32 x f32 (the
split route for direct and fused); it counts the HGMMA instructions in the
tensor-core libraries' SASS (``cuobjdump``).  Then the gram tier's slice
shapes (B 2, S 2048, bf16): fused over the 16 q/o layers (the record; the
layer table must give the stack's bits) and the 16 k/v layers, gram at
4096 -> 11008 (tensor cores), direct at q with float32 deltas as the
standalone entry point calls it (the split route, bound by the function's
one product at the bf16 rate, the floor of its 3 products beside it; its
peak memory) and the split of those deltas alone
(bit for bit against its plain version), direct at q in f32 x f32 (6
products) and gram at 4096 -> 11008 in float32 (FMA), timed beside the
plain version and a cuBLAS yardstick, each with its route and achieved
TFLOP/s.  Products of bf16 values are exact in float32, so every psgn case
is held at 1e-4 relative, and prints the plain values beside its error.
The chunk forward is also timed at the training shape (B 2, S 2048)
beside the forward of ``F.scaled_dot_product_attention``, with its bound.

Phase 3 also holds the int8 quantisation kernel against its plain version,
codes and scales BIT FOR BIT, float32 and bf16: rows not a multiple of a
block, C of 1 and ragged, a long row, an all-zero row, exact .5 ties,
negative-max rows, rows holding a NaN or an infinity (NaN in the same
rows), the pod slice's MLP leaves, the one-pass design's longest row
(32768) and one either side, views at an offset (1 and 8 elements) in both
designs, ragged rows over the two-pass design; then Yi-6B-width leaves, per
tensor (1, 4096 x 11008) float32 (the record: the compressor views a leaf
as one row), rowwise (11008, 4096) in float32 and bf16, and the pod
slice's largest leaf, each with its design, timed beside the plain version
and a library yardstick (amax, divide, round, clamp, cast); bound = bytes
/ 3.35 TB/s, and the two-read floor beside it where a row outgrows the 50
MB L2.

 10. the pod slice: the paper's ``Trainer`` on ``PodLadder(pods=2,
     granule=16)`` over eight virtual devices on the card, the MLP (512 ->
     64 -> 1) on ``sigmoid_synthetic(n=20000, d=512)``, sgd with momentum
     0.9 (lr 0.1), DiveBatch on the moment tier (m0 64 on rung 2, m_max
     128, delta 0.1: Delta is near 1 at the first boundary, so the run moves
     to batch 128 on the cross-pod rung 3); 3 epochs, then pod 1 is marked
     lost, ``demote`` moves the run 3 -> 2, and one more epoch.  The launch
     counts, set to 0 before and read after, must be exactly 2 pods x 4
     leaves ``quantize_int8`` launches per cross-pod step and nothing else;
     prints per epoch the batch, rung, losses and ms per step, the wire
     bytes per exchange and the peak memory;
 11. the pod slice on the card against the CPU: the same run for 2 epochs
     on ``[cuda:0] * 8`` and ``[cpu] * 8`` from identical weights: the same
     (batch, rung, steps) schedule, losses within 1e-3 relative,
     parameters within 1e-2; the codes that differ at the last exchange
     are counted and printed (the runs have drifted apart by then), and at
     one exchange from the same state and batch on both devices at most 8
     of the 65794 codes may differ, and the others' residuals by at most
     1e-3 quanta.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.  A record's ``ms`` is CUDA events
around the call, the host's queueing included where the card waits for it;
``device_ms`` is the same call with the card kept busy until the host has
queued it, the card's time alone.  It imports nothing of JAX.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.adapt import AdaptationProgram, DiveBatchPolicy  # noqa: E402
from repro_torch.data import TokenStream, sigmoid_synthetic  # noqa: E402
from repro_torch.elastic import place  # noqa: E402
from repro_torch.kernels import _build, ops, psgn, quant, ref  # noqa: E402
from repro_torch.kernels import attention as kattn  # noqa: E402
from repro_torch.launch import train_lm  # noqa: E402
from repro_torch.models import probes, small  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.pod import PodLadder  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.train import StepEngine, lm_bucket_of, make_train_step  # noqa: E402
from repro_torch.train.loop import ModelFns, Trainer  # noqa: E402

# H100 SXM peaks at a 700 W limit (NVIDIA data sheet): HBM3 bytes/s, dense
# bf16 tensor-core FLOP/s, and float32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# (atol, rtol) of the flash backward's float32 outputs, by input dtype
FLASH_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-3, 0.0)}
YI = get_config("yi-6b")
NO_PSGN = {"psgn_direct": 0, "psgn_gram": 0, "psgn_fused": 0, "psgn_split": 0,
           "quantize_int8": 0}


def phase(name: str) -> None:
    print(f"\n== {name}", flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

_FLUSH = None


# cycles the card spins before a call timed with ``spin=True`` (about 1 ms
# at the H100's clock), so the host has queued the whole call before its
# start event runs
SPIN_CYCLES = 2_000_000


def timed_ms(fn, iters: int = 10, *, spin: bool = False) -> float:
    """Median time of one call: CUDA events around each call, a 64 MiB
    write between calls so the 50 MB L2 starts cold.  The time includes
    whatever part of the host's work to queue the call (argument checks,
    tensor maps, the launch) the card waits for.  With ``spin`` the card
    spins before the start event, so that host work is hidden and the time
    is the card's alone (the kernel records' ``device_ms``)."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        _FLUSH.zero_()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(n_bytes: float, flops: float, peak: float = PEAK_BF16) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / PEAK_BYTES, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def check(name: str, got: torch.Tensor, want: torch.Tensor, dtype, *,
          tol: tuple[float, float] | None = None) -> float:
    """Max abs error of ``got``; fails where it passes ``atol + rtol * |want|``
    (both ``TOL[dtype]`` unless ``tol`` gives them)."""
    err = (got.float() - want.float()).abs()
    atol, rtol = tol if tol is not None else (TOL[dtype], TOL[dtype])
    bad = err > atol + rtol * want.float().abs()
    if bad.any() or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: max abs err {err.max().item():.3e} "
                             f"over tolerance atol {atol}, rtol {rtol} "
                             f"({int(bad.sum())} elements)")
    return err.max().item()


def rms(t: torch.Tensor) -> float:
    return t.float().square().mean().sqrt().item()


ROUTED_ATTENTION = ("chunk_attention", "flash_dq", "flash_dkv")


def attention_routes() -> dict:
    routes = kernels.route_counts()
    return {k: routes[k] for k in ROUTED_ATTENTION}


def attn_routes(counts: dict, *, tc: bool, what: str) -> None:
    """Every chunk-forward, dq and dk/dv launch of the run just read took the
    tensor cores (``tc``, bf16) or the FMA kernels (float32)."""
    route, other = ("tc", "fma") if tc else ("fma", "tc")
    want = {name: {route: counts[name], other: 0} for name in ROUTED_ATTENTION}
    if attention_routes() != want or counts["chunk_attention"] == 0:
        raise AssertionError(f"{what}: attention routes {attention_routes()}, expected {want}")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def chunk_inputs(r, dtype, *, b, c, prior_real, prior_blocks, blk, h, kv, hd,
                 window=None, pad_rows=0):
    """A chunked-prefill attention call: ``prior_real`` valid prior tokens in
    a table of ``prior_blocks`` blocks (the rest sentinel garbage), then the
    chunk's own ``c`` keys; queries at absolute positions from prior_real."""
    prior = prior_blocks * blk
    sk = prior + c
    dev = "cuda"
    q = torch.from_numpy(r.standard_normal((b, c, h, hd))).to(dev, dtype)
    k = torch.from_numpy(r.standard_normal((b, sk, kv, hd))).to(dev, dtype)
    v = torch.from_numpy(r.standard_normal((b, sk, kv, hd))).to(dev, dtype)
    q_pos = prior_real + torch.arange(c, dtype=torch.int32, device=dev)
    if pad_rows:
        q_pos[-pad_rows:] = -(2 ** 30)
    k_pos = torch.cat([torch.arange(prior, dtype=torch.int32, device=dev),
                       prior_real + torch.arange(c, dtype=torch.int32, device=dev)])
    k_valid = torch.cat([torch.arange(prior, device=dev) < prior_real,
                         torch.ones(c, dtype=torch.bool, device=dev)])
    return dict(q=q, k=k, v=v, q_pos=q_pos, k_pos=k_pos, k_valid=k_valid,
                window=window)


def chunk_case(name, inp, softcap=None):
    dtype = inp["q"].dtype
    args = (inp["q"], inp["k"], inp["v"], inp["q_pos"], inp["k_pos"], inp["k_valid"])
    route = kattn.attention_plan(dtype, inp["q"].shape[-1])
    if route == "tc":
        kattn.tc_key_tiles(reset=True)
    out, lse = kattn.chunk_attention_fwd(*args, window=inp["window"], softcap=softcap)
    torch.cuda.synchronize()
    want, want_lse = ref.attention_ref_lse(*args, window=inp["window"], softcap=softcap)
    err = check(name, out, want, dtype)
    check(name + " lse", lse, want_lse, dtype)
    tiles = ""
    if route == "tc":
        # counted by the kernel's blocks: tiles loaded and multiplied
        seen, total = kattn.tc_key_tiles(reset=True)
        tiles = f"; key tiles visited {seen} of {total}"
    print(f"  chunk {name} [{route}]: max abs err {err:.3e} (tol {TOL[dtype]}){tiles}")
    return err


def valid_pairs(q_pos, k_pos, k_valid, window=None) -> int:
    rel = q_pos[:, None].long() - k_pos[None, :].long()
    ok = (q_pos[:, None] >= 0) & k_valid.bool()[None, :] & (rel >= 0)
    if window is not None:
        ok &= rel < window
    return int(ok.sum())


def chunk_kernel_record(r) -> dict:
    h, kv, hd = YI.num_heads, YI.num_kv_heads, YI.resolved_head_dim
    inp = chunk_inputs(r, torch.bfloat16, b=1, c=256, prior_real=768,
                       prior_blocks=64, blk=16, h=h, kv=kv, hd=hd)
    err = chunk_case("slice shape bf16 (C 256, 768 prior in 64 blocks, Sk 1280)", inp)
    args = (inp["q"], inp["k"], inp["v"], inp["q_pos"], inp["k_pos"], inp["k_valid"])
    ms = timed_ms(lambda: kattn.chunk_attention_fwd(*args))
    device_ms = timed_ms(lambda: kattn.chunk_attention_fwd(*args), spin=True)
    plain_ms = timed_ms(lambda: ref.attention_ref_lse(*args))
    # library yardstick: SDPA with the same boolean mask, GQA grouping
    rel = inp["q_pos"][:, None].long() - inp["k_pos"][None, :].long()
    mask = ((rel >= 0) & inp["k_valid"][None, :] & (inp["q_pos"][:, None] >= 0))
    qt, kt, vt = (x.transpose(1, 2) for x in (inp["q"], inp["k"], inp["v"]))
    library_ms = timed_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask[None, None], enable_gqa=True))
    pairs = valid_pairs(inp["q_pos"], inp["k_pos"], inp["k_valid"])
    moved = nbytes(*args) + nbytes(inp["q"]) + 256 * h * 4  # + out + lse
    flops = 4 * pairs * h * hd
    bound_ms, by = bound(moved, flops)
    dispatch = kattn.attention_plan(inp["q"].dtype, hd)
    print(f"  chunk_attention at the serving shape [{dispatch}]: {ms:.4f} ms ({device_ms:.4f} "
          f"on the card alone), {flops / ms / 1e9:.1f} TFLOP/s (library {library_ms:.4f}); "
          f"bound {bound_ms:.4f} ms by {by}, {100 * bound_ms / ms:.1f}% of it")
    return {"name": "chunk_attention", "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/chunk_attention{'_tc' if dispatch == 'tc' else ''}.cu",
            "replaces": "src/repro/kernels/attention.py:92",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": library_ms,
            "device_ms": device_ms, "dispatch": dispatch, "tflops": flops / ms / 1e9}


def decode_inputs(r, dtype, *, b, blk, n_max, nb, kv, h, hd, max_len):
    dev = "cuda"
    pool_k = torch.from_numpy(r.standard_normal((nb, blk, kv, hd))).to(dev, dtype)
    pool_v = torch.from_numpy(r.standard_normal((nb, blk, kv, hd))).to(dev, dtype)
    tables = np.zeros((b, n_max), np.int32)
    lengths = r.integers(1, max_len + 1, size=b).astype(np.int32)
    ids = list(range(1, nb))
    r.shuffle(ids)  # out-of-order pool ids
    for row in range(b):
        n_live = -(-int(lengths[row]) // blk)
        tables[row, :n_live] = ids[:n_live]  # dead entries stay at sentinel 0
        ids = ids[n_live:]
    q = torch.from_numpy(r.standard_normal((b, 1, h, hd))).to(dev, dtype)
    return (q, pool_k, pool_v, torch.from_numpy(tables).to(dev),
            torch.from_numpy(lengths).to(dev))


def decode_case(name, args, softcap=None) -> float:
    dtype = args[0].dtype
    out = kattn.paged_decode_attention(*args, softcap=softcap)
    torch.cuda.synchronize()
    want = ref.paged_decode_ref(*args, softcap=softcap)
    err = check(name, out, want, dtype)
    print(f"  decode {name}: max abs err {err:.3e} (tol {TOL[dtype]})")
    return err


def decode_kernel_record(r) -> dict:
    h, kv, hd = YI.num_heads, YI.num_kv_heads, YI.resolved_head_dim
    blk, n_max = 16, 192  # the engine's table width at max_seq 2048
    args = decode_inputs(r, torch.bfloat16, b=8, blk=blk, n_max=n_max, nb=2048,
                         kv=kv, h=h, hd=hd, max_len=1100)
    err = decode_case("slice shape bf16 (B 8, block 16, lengths <= 1100)", args)
    q, pool_k, pool_v, tables, lengths = args
    splits = kattn.paged_decode_attention.splits
    # a fixed split order and no atomics: the same bits on every launch
    outs = [kattn.paged_decode_attention(*args) for _ in range(20)]
    if not all(torch.equal(outs[0], o) for o in outs[1:]):
        raise AssertionError("paged decode: 20 launches gave different bits")
    del outs
    ms = timed_ms(lambda: kattn.paged_decode_attention(*args))
    device_ms = timed_ms(lambda: kattn.paged_decode_attention(*args), spin=True)
    plain_ms = timed_ms(lambda: ref.paged_decode_ref(*args))
    # library yardstick on the materialised gather (the gather is not timed)
    b = q.shape[0]
    idx = tables.reshape(-1).long()
    gk = pool_k[idx].reshape(b, n_max * blk, kv, hd).transpose(1, 2)
    gv = pool_v[idx].reshape(b, n_max * blk, kv, hd).transpose(1, 2)
    mask = torch.arange(n_max * blk, device="cuda")[None, :] < lengths[:, None]
    qt = q.transpose(1, 2)
    library_ms = timed_ms(lambda: F.scaled_dot_product_attention(
        qt, gk, gv, attn_mask=mask[:, None, None, :], enable_gqa=True))
    tokens = int(lengths.sum())
    live_kv = 2 * tokens * kv * hd * pool_k.element_size()
    moved = live_kv + 2 * nbytes(q) + nbytes(tables, lengths)
    bound_ms, by = bound(moved, 4 * tokens * h * hd)
    print(f"  paged_decode_attention at the serving shape: plan {splits} splits "
          f"({splits * kv * b} blocks); 20 launches bit-identical; {ms:.4f} ms "
          f"({device_ms:.4f} on the card alone; plain {plain_ms:.4f}, library "
          f"{library_ms:.4f}); bound {bound_ms:.4f} ms by {by}, "
          f"{100 * bound_ms / device_ms:.1f}% of it alone")
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
            "replaces": "src/repro/kernels/attention.py:448",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": library_ms,
            "device_ms": device_ms, "splits": splits}


def decode_split_cases(r) -> None:
    """The split decode at its edges, at the serving widths (B 8, 32/4
    heads, hd 128, block 16, n_max 192: the plan's 9 splits on 132 SMs), in
    both types: lengths 1 and one block, a length on a split boundary (288:
    18 entries in shares of 2) and one token either side (289 leaves one
    token in the seventh share and two empty shares), a full table, and two
    free lanes whose tables are all sentinel (lengths that kept counting,
    the second past the table)."""
    h, kv, hd = YI.num_heads, YI.num_kv_heads, YI.resolved_head_dim
    blk, n_max = 16, 192
    lens = [1, blk, 287, 288, 289, n_max * blk, 37, 5000]
    tables = np.zeros((len(lens), n_max), np.int32)
    ids = list(range(1, 2048))
    r.shuffle(ids)
    for row, n in enumerate(lens[:6]):
        live = -(-n // blk)
        tables[row, :live] = ids[:live]
        ids = ids[live:]
    for dtype in (torch.float32, torch.bfloat16):
        q, pool_k, pool_v, _, _ = decode_inputs(r, dtype, b=len(lens), blk=blk, n_max=n_max,
                                                nb=2048, kv=kv, h=h, hd=hd, max_len=1)
        args = (q, pool_k, pool_v, torch.from_numpy(tables).to("cuda"),
                torch.tensor(lens, dtype=torch.int32, device="cuda"))
        tag = "f32" if dtype == torch.float32 else "bf16"
        decode_case(f"{tag} split edges (lengths {lens}, rows 6-7 all sentinel)", args)
        print(f"    ({kattn.paged_decode_attention.splits} splits)")


def flash_inputs(r, dtype, *, b, s, h, kv, hd, window=None, softcap=None) -> dict:
    """One flash backward call: q, k, v, dout and the card forward's out and
    lse, the pairing the training path uses."""
    dev = "cuda"
    q = torch.from_numpy(r.standard_normal((b, s, h, hd))).to(dev, dtype)
    k = torch.from_numpy(r.standard_normal((b, s, kv, hd))).to(dev, dtype)
    v = torch.from_numpy(r.standard_normal((b, s, kv, hd))).to(dev, dtype)
    dout = torch.from_numpy(r.standard_normal((b, s, h, hd))).to(dev, dtype)
    pos = torch.arange(s, dtype=torch.int32, device=dev)
    out, lse = kattn.chunk_attention_fwd(q, k, v, pos, pos, torch.ones_like(pos),
                                         window=window, softcap=softcap)
    return dict(q=q, k=k, v=v, dout=dout, out=out, lse=lse,
                delta=ref.flash_delta(out, dout), window=window, softcap=softcap)


def flash_case(name, inp) -> tuple[float, float]:
    dtype = inp["q"].dtype
    kw = dict(window=inp["window"], softcap=inp["softcap"])
    args = (inp["q"], inp["k"], inp["v"], inp["dout"], inp["lse"], inp["delta"])
    dq = kattn.flash_dq(*args, **kw)
    dk, dv = kattn.flash_dkv(*args, **kw)
    torch.cuda.synchronize()
    want = ref.flash_backward_ref(inp["q"], inp["k"], inp["v"], inp["out"], inp["lse"],
                                  inp["dout"], **kw)
    tol = FLASH_TOL[dtype]
    err_dq = check(name + " dq", dq, want[0], dtype, tol=tol)
    err_dkv = max(check(name + " dk", dk, want[1], dtype, tol=tol),
                  check(name + " dv", dv, want[2], dtype, tol=tol))
    route = kattn.attention_plan(dtype, inp["q"].shape[-1])
    print(f"  flash backward {name} [dq, dk/dv {route}]: max abs err dq {err_dq:.3e}, dk/dv {err_dkv:.3e} "
          f"(atol {tol[0]}, rtol {tol[1]}); rms of the plain dq {rms(want[0]):.3e}, "
          f"dk {rms(want[1]):.3e}, dv {rms(want[2]):.3e}")
    return err_dq, err_dkv


def flash_kernel_records(r) -> list[dict]:
    """dq and dk/dv at the training shape: B 2, S 2048, Yi-6B heads, bf16."""
    b, s = 2, 2048
    h, kv, hd = YI.num_heads, YI.num_kv_heads, YI.resolved_head_dim
    inp = flash_inputs(r, torch.bfloat16, b=b, s=s, h=h, kv=kv, hd=hd)
    err_dq, err_dkv = flash_case(f"slice shape bf16 (B {b}, S {s})", inp)
    q, k, v, dout, lse, delta = (inp[n] for n in ("q", "k", "v", "dout", "lse", "delta"))
    dq_ms = timed_ms(lambda: kattn.flash_dq(q, k, v, dout, lse, delta))
    dkv_ms = timed_ms(lambda: kattn.flash_dkv(q, k, v, dout, lse, delta))
    dq_dev = timed_ms(lambda: kattn.flash_dq(q, k, v, dout, lse, delta), spin=True)
    dkv_dev = timed_ms(lambda: kattn.flash_dkv(q, k, v, dout, lse, delta), spin=True)
    # the plain version computes dq, dk and dv in one call
    plain_ms = timed_ms(lambda: ref.flash_grads_ref(q, k, v, lse, delta, dout))
    # library yardstick: the backward of SDPA (dq, dk and dv in one call)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    gt = dout.transpose(1, 2)
    library_ms = timed_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), gt,
                                                      retain_graph=True))
    pos = torch.arange(s, dtype=torch.int32, device="cuda")
    ones = torch.ones_like(pos)
    # the forward at the training shape against its plain version
    fwd_err = chunk_case(f"training shape bf16 (B {b}, S {s}, {h}/{kv} heads)",
                         dict(q=q, k=k, v=v, q_pos=pos, k_pos=pos, k_valid=ones, window=None))
    fwd_ms = timed_ms(lambda: kattn.chunk_attention_fwd(q, k, v, pos, pos, ones))
    fwd_dev = timed_ms(lambda: kattn.chunk_attention_fwd(q, k, v, pos, pos, ones), spin=True)
    with torch.no_grad():
        sdpa_ms = timed_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
    pairs = b * h * s * (s + 1) // 2  # causal (row, key) pairs over all (b, h)
    # the forward: q k^T and p v, 2 hd multiply-adds per causal pair; q, k, v
    # read once and the output written once
    fwd_bound, fwd_by = bound(nbytes(q, k, v, q), 4 * hd * pairs)
    print(f"  chunk_attention at the training shape (B {b}, S {s}, causal) "
          f"[{kattn.attention_plan(q.dtype, hd)}]: {fwd_ms:.4f} ms ({fwd_dev:.4f} on the card "
          f"alone), {4 * hd * pairs / fwd_ms / 1e9:.1f} TFLOP/s (library {sdpa_ms:.4f}: SDPA "
          f"forward); bound {fwd_bound:.4f} ms by {fwd_by}, {100 * fwd_bound / fwd_ms:.1f}% of "
          f"it; max abs err {fwd_err:.3e}")
    read = nbytes(q, k, v, dout, lse, delta)
    dq_bound, dq_by = bound(read + b * s * h * hd * 4, 3 * 2 * hd * pairs)
    dkv_bound, dkv_by = bound(read + 2 * b * s * kv * hd * 4, 4 * 2 * hd * pairs)
    route = kattn.attention_plan(q.dtype, hd)
    for label, ms, dev, flops, bnd in (
            (f"flash_dq [{route}]", dq_ms, dq_dev, 3 * 2 * hd * pairs, dq_bound),
            (f"flash_dkv [{route}]", dkv_ms, dkv_dev, 4 * 2 * hd * pairs, dkv_bound)):
        print(f"  {label} at the training shape: {ms:.4f} ms ({dev:.4f} on the card alone), "
              f"{flops / ms / 1e9:.1f} TFLOP/s (library {library_ms:.4f}: SDPA backward); "
              f"bound {bnd:.4f} ms, {100 * bnd / ms:.1f}% of it")
    del out, qt, kt, vt, inp
    common = {"route": "cuda", "plain_ms": plain_ms, "library_ms": library_ms,
              "dispatch": route}
    tc = "_tc" if route == "tc" else ""
    return [
        {"name": "flash_dq", "source": f"src/repro_torch/kernels/csrc/flash_dq{tc}.cu",
         "replaces": "src/repro/kernels/attention.py:218", "max_abs_err": err_dq,
         "ms": dq_ms, "bound_ms": dq_bound, "bound_by": dq_by, **common,
         "device_ms": dq_dev, "tflops": 3 * 2 * hd * pairs / dq_ms / 1e9},
        {"name": "flash_dkv", "source": f"src/repro_torch/kernels/csrc/flash_dkv{tc}.cu",
         "replaces": "src/repro/kernels/attention.py:245", "max_abs_err": err_dkv,
         "ms": dkv_ms, "bound_ms": dkv_bound, "bound_by": dkv_by, **common,
         "device_ms": dkv_dev, "tflops": 4 * 2 * hd * pairs / dkv_ms / 1e9},
    ]


def tc_attention_cases(r) -> None:
    """The tensor-core chunk forward and dk/dv (bf16, hd 64 and 128) at the
    edges the loops above do not reach."""
    bf = torch.bfloat16
    chunk_case("tc n_rep 4, C 45 < 64, Sk 301, softcap 30, window 50 across tiles",
               chunk_inputs(r, bf, b=2, c=45, prior_real=200, prior_blocks=16, blk=16,
                            h=8, kv=2, hd=128, window=50), softcap=30.0)
    chunk_case("tc hd 64, n_rep 1, a prior table of 40 blocks with 100 valid tokens "
               "(sentinel-only tail tiles)",
               chunk_inputs(r, bf, b=1, c=70, prior_real=100, prior_blocks=40, blk=16,
                            h=4, kv=4, hd=64))
    chunk_case("tc hd 64, one query row (C 1)",
               chunk_inputs(r, bf, b=3, c=1, prior_real=33, prior_blocks=4, blk=16, h=4,
                            kv=2, hd=64))
    # rows 10-12's keys within the window (3) are all invalid: row 12 attends
    # no key at all and takes the mean of v over every key
    inp = chunk_inputs(r, bf, b=1, c=40, prior_real=0, prior_blocks=0, blk=16, h=8, kv=1,
                       hd=128, window=3)
    inp["k_valid"][10:13] = False
    chunk_case("tc n_rep 8, a live row with no attendable key (window 3)", inp)
    # keys shuffled (k_pos not monotonic) at positions past the array bounds
    inp = chunk_inputs(r, bf, b=2, c=100, prior_real=300, prior_blocks=25, blk=16, h=8,
                       kv=2, hd=64)
    perm = torch.from_numpy(r.permutation(inp["k"].shape[1])).to("cuda")
    for key in ("k", "v"):
        inp[key] = inp[key][:, perm].contiguous()
    inp["k_pos"] = inp["k_pos"][perm] + 5000
    inp["k_valid"] = inp["k_valid"][perm]
    inp["q_pos"] = inp["q_pos"] + 5000
    chunk_case("tc shuffled keys, positions past the array bounds (+5000)", inp)
    chunk_case("tc 128-row blocks (B 2, C 300, 32/4 heads), 7 padded rows, softcap 20, "
               "window 200",
               chunk_inputs(r, bf, b=2, c=300, prior_real=500, prior_blocks=40, blk=16,
                            h=32, kv=4, hd=128, window=200, pad_rows=7), softcap=20.0)
    flash_case("tc n_rep 4, hd 64, ragged S 200, window 70",
               flash_inputs(r, bf, b=2, s=200, h=8, kv=2, hd=64, window=70))
    flash_case("tc n_rep 4, hd 128, ragged S 129, softcap 30",
               flash_inputs(r, bf, b=1, s=129, h=16, kv=4, hd=128, softcap=30.0))
    # dq's 128-row blocks: a single row, ragged and whole 64-row tiles, a
    # block whose second warpgroup has no row, n_rep 1, 2 and 8 in turn
    n_reps = (1, 2, 8)
    for i, (s, hd) in enumerate((s, hd) for s in (1, 63, 64, 65, 129, 300) for hd in (64, 128)):
        n_rep = n_reps[i % 3]
        kv = 8 // n_rep if n_rep < 8 else 1
        flash_case(f"tc S {s}, hd {hd}, n_rep {n_rep}",
                   flash_inputs(r, bf, b=2, s=s, h=kv * n_rep, kv=kv, hd=hd))
    flash_case("tc n_rep 2, hd 128, S 300, window 70 across tiles",
               flash_inputs(r, bf, b=1, s=300, h=8, kv=4, hd=128, window=70))
    flash_case("tc n_rep 8, hd 64, S 200, softcap 20",
               flash_inputs(r, bf, b=1, s=200, h=16, kv=2, hd=64, softcap=20.0))


# per-sample gradient norms: f32 and bf16 inputs, and bf16 activations with
# the float32 deltas the standalone entry point passes; products of bf16
# values are exact in float32, so every case is held at 1e-4 relative
PSGN_TOL = 1e-4
PSGN_TYPES = {"f32": (torch.float32, torch.float32), "bf16": (torch.bfloat16,) * 2,
              "bf16 x f32": (torch.bfloat16, torch.float32),
              "f32 x bf16": (torch.float32, torch.bfloat16)}


def psgn_inputs(r, shape, dtypes):
    """x (..., S, Din) and delta (..., S, Dout) on the card for the shape
    (..., S, Din, Dout)."""
    *lead, s, d_in, d_out = shape
    x = torch.from_numpy(r.standard_normal((*lead, s, d_in))).to("cuda", dtypes[0])
    d = torch.from_numpy(r.standard_normal((*lead, s, d_out))).to("cuda", dtypes[1])
    return x, d


def psgn_check(name, got, want) -> tuple[float, float]:
    """(max abs err, max rel err) of a (B,) psgn result; fails over
    PSGN_TOL relative."""
    err = (got - want.float()).abs()
    rel = (err / want.float().abs()).max().item()
    if rel > PSGN_TOL or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: max rel err {rel:.3e} > {PSGN_TOL}")
    return err.max().item(), rel


def psgn_case(name, shape, dtypes, r) -> None:
    x, d = psgn_inputs(r, shape, dtypes)
    xs, ds = psgn_inputs(r, (3, *shape), dtypes)
    s, d_in, d_out = shape[1:]
    for label, kind, got, want in (
            ("direct", "direct", psgn.psgn_direct(x, d), ref.psgn_ref(x, d)),
            ("gram", "gram", psgn.psgn_gram(x, d), ref.psgn_gram_ref(x, d)),
            ("fused (L 3)", "direct", psgn.psgn_fused(xs, ds), ref.psgn_fused_ref(xs, ds))):
        torch.cuda.synchronize()
        _, rel = psgn_check(f"psgn {label} {name}", got, want)
        route = psgn.plan(kind, x.dtype, d.dtype, s, d_in, d_out).route
        print(f"  psgn {label} {name} [{route}]: max rel err {rel:.3e} (tol {PSGN_TOL}); "
              f"plain {want.min().item():.6e}..{want.max().item():.6e}")


def psgn_record(name, run, plain, library, *, err, moved, flops, peak, replaces,
                dispatch, pairs=1) -> dict:
    """A psgn kernel's record; ``dispatch`` is its route, "tc" (tensor
    cores), "split" (float32 operands split for the tensor cores) or "fma",
    which names its source.  ``flops`` is the function's, and the bound
    counts those; the split route runs ``pairs`` bf16 products of them, and
    its own floor (``split_floor_ms``, at the bf16 rate) is kept beside the
    bound.  Adds the achieved TFLOP/s of the function."""
    ms, plain_ms, library_ms = timed_ms(run), timed_ms(plain), timed_ms(library)
    device_ms = timed_ms(run, spin=True)
    bound_ms, by = bound(moved, flops, peak)
    lib = "psgn_gram" if name == "psgn_gram" else "psgn_direct"
    source = f"src/repro_torch/kernels/csrc/{lib}{'' if dispatch == 'fma' else '_tc'}.cu"
    rec = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": by, "library_ms": library_ms, "device_ms": device_ms,
           "dispatch": dispatch, "tflops": flops / ms / 1e9}
    if dispatch == "split":
        rec["pairs"] = pairs
        rec["split_floor_ms"] = bound(moved, pairs * flops, PEAK_BF16)[0]
    return rec


def psgn_line(label, rec) -> None:
    floor = ""
    if "split_floor_ms" in rec:
        floor = (f"; the split design's own floor ({rec['pairs']} bf16 products) "
                 f"{rec['split_floor_ms']:.4f} ms, {100 * rec['split_floor_ms'] / rec['ms']:.1f}%"
                 f" of it, {rec['pairs'] * rec['tflops']:.1f} TFLOP/s on the tensor cores")
    print(f"  {label} [{rec['dispatch']}]: {rec['ms']:.4f} ms ({rec['device_ms']:.4f} on the "
          f"card alone), {rec['tflops']:.1f} TFLOP/s "
          f"(plain {rec['plain_ms']:.4f}, library {rec['library_ms']:.4f}); bound "
          f"{rec['bound_ms']:.4f} ms by {rec['bound_by']}, "
          f"{100 * rec['bound_ms'] / rec['ms']:.1f}% of it{floor}")


def sass_hgmma() -> None:
    """How many HGMMA (wgmma) instructions the tensor-core libraries hold,
    where the toolkit has ``cuobjdump``."""
    tool = Path(_build.nvcc()).with_name("cuobjdump")
    if not tool.exists():
        print("  HGMMA in SASS: no cuobjdump beside nvcc")
        return
    counts = {}
    for name in ("psgn_direct_tc", "psgn_gram_tc", "chunk_attention_tc", "flash_dq_tc",
                 "flash_dkv_tc"):
        sass = subprocess.run([str(tool), "-sass", str(_build.library_path(name))],
                              capture_output=True, text=True, check=True).stdout
        counts[name] = sum("HGMMA" in line for line in sass.splitlines())
    print("  HGMMA in SASS: " + ", ".join(f"{k} {v}" for k, v in counts.items()))
    if not all(counts.values()):
        raise AssertionError(f"a tensor-core library has no HGMMA: {counts}")


def split_record(d: torch.Tensor) -> dict:
    """The split of float32 ``d`` into bf16 terms, held bit for bit against
    its plain version; bound by bytes (4 read, 6 written per element), no
    library call computes it."""
    got, want = psgn.psgn_split([d]), ref.split_bf16(d)[:, None]
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int16), want.view(torch.int16)):
        raise AssertionError("psgn_split: the terms differ from the plain version's bits")
    del got, want
    ms = timed_ms(lambda: psgn.psgn_split([d]))
    device_ms = timed_ms(lambda: psgn.psgn_split([d]), spin=True)
    plain_ms = timed_ms(lambda: ref.split_bf16(d))
    bound_ms, by = bound(nbytes(d) + 3 * 2 * d.numel(), 0.0)
    print(f"  psgn_split of the float32 deltas at q {tuple(d.shape)}: bit-exact; {ms:.4f} ms "
          f"({device_ms:.4f} on the card alone; plain {plain_ms:.4f}, no library call); "
          f"bound {bound_ms:.4f} ms by {by}, {100 * bound_ms / ms:.1f}% of it")
    return {"name": "psgn_split", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/psgn_split.cu",
            "replaces": "src/repro/kernels/psgn.py:65", "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by, "library_ms": None,
            "device_ms": device_ms}


def psgn_kernel_records(r) -> list[dict]:
    """The gram tier's launches at Yi-6B widths, B 2, S 2048: fused over the
    16 q/o layers (the record) and the 16 k/v layers, gram at gate/up
    (4096 -> 11008), direct at q as the standalone entry point calls it (bf16
    activations, float32 deltas: the split route, and the split itself);
    then, printed beside them, direct at q with float32 activations too (6
    term pairs) and gram at gate/up in float32 (the FMA kernel)."""
    b, s, d, f = 2, 2048, YI.d_model, YI.d_ff
    kv = YI.num_kv_heads * YI.resolved_head_dim
    bf16 = PSGN_TYPES["bf16"]

    def fused_case(d_out):
        xs, ds = psgn_inputs(r, (16, b, s, d, d_out), bf16)
        got = psgn.psgn_fused(xs, ds)
        want = ref.psgn_fused_ref(xs, ds)
        err, rel = psgn_check(f"psgn_fused slice (L 16, {d} -> {d_out})", got, want)
        print(f"  psgn_fused slice bf16 (L 16, B {b}, S {s}, {d} -> {d_out}): max rel err "
              f"{rel:.3e}; plain {want.min().item():.6e}..{want.max().item():.6e}")
        rec = psgn_record(
            "psgn_fused", lambda: psgn.psgn_fused(xs, ds), lambda: ref.psgn_fused_ref(xs, ds),
            lambda: torch.bmm(xs.flatten(0, 1).mT, ds.flatten(0, 1)).float().square()
            .sum((1, 2)).view(16, b).sum(0),
            err=err, moved=nbytes(xs, ds) + 4 * b, flops=2 * 16 * b * s * d * d_out,
            peak=PEAK_BF16, replaces="src/repro/kernels/psgn.py:182",
            dispatch=psgn.plan("direct", xs.dtype, ds.dtype, s, d, d_out, 16).route)
        # the layer table the gram tier launches: the same bits as the stack
        table = psgn.psgn_fused_layers(list(xs), list(ds))
        if not torch.equal(table, got):
            raise AssertionError(f"psgn_fused_layers {table.tolist()} != stacked {got.tolist()}")
        del xs, ds
        return rec

    fused = fused_case(d)
    psgn_line(f"psgn_fused at the q/o group (L 16, {d} -> {d})", fused)
    fused_kv = fused_case(kv)
    psgn_line(f"psgn_fused at the k/v group (L 16, {d} -> {kv})", fused_kv)

    x, dl = psgn_inputs(r, (b, s, d, f), bf16)
    got, want = psgn.psgn_gram(x, dl), ref.psgn_gram_ref(x, dl)
    err, rel = psgn_check("psgn_gram slice", got, want)
    print(f"  psgn_gram slice bf16 (B {b}, S {s}, {d} -> {f}): max rel err {rel:.3e}; "
          f"plain {want.min().item():.6e}..{want.max().item():.6e}")
    # the kernel forms the upper triangle of both Gram matrices: S(S+1)/2
    # position pairs, a multiply-add per feature of each
    gram = psgn_record(
        "psgn_gram", lambda: psgn.psgn_gram(x, dl), lambda: ref.psgn_gram_ref(x, dl),
        lambda: (torch.bmm(x, x.mT) * torch.bmm(dl, dl.mT)).sum((1, 2)),
        err=err, moved=nbytes(x, dl) + 4 * b, flops=b * s * (s + 1) * (d + f),
        peak=PEAK_BF16, replaces="src/repro/kernels/psgn.py:129",
        dispatch=psgn.plan("gram", x.dtype, dl.dtype, s, d, f).route)
    psgn_line(f"psgn_gram at gate/up ({d} -> {f})", gram)
    del x, dl

    x, dl = psgn_inputs(r, (b, s, d, d), PSGN_TYPES["bf16 x f32"])
    got, want = psgn.psgn_direct(x, dl), ref.psgn_ref(x, dl)
    err, rel = psgn_check("psgn_direct slice", got, want)
    print(f"  psgn_direct slice bf16 x f32 (B {b}, S {s}, {d} -> {d}): max rel err "
          f"{rel:.3e}; plain {want.min().item():.6e}..{want.max().item():.6e}")
    # the split route: T products of bf16 terms on the tensor cores; the
    # bound counts the function's one product at the bf16 rate
    p = psgn.plan("direct", x.dtype, dl.dtype, s, d, d)
    direct = psgn_record(
        "psgn_direct", lambda: psgn.psgn_direct(x, dl), lambda: ref.psgn_ref(x, dl),
        lambda: torch.bmm(x.float().mT, dl).square().sum((1, 2)),
        err=err, moved=nbytes(x, dl) + 4 * b, flops=2 * b * s * d * d,
        peak=PEAK_BF16, replaces="src/repro/kernels/psgn.py:65", dispatch=p.route,
        pairs=p.pairs)
    psgn_line(f"psgn_direct at q, float32 deltas ({d} -> {d}, {p.pairs} term pairs)", direct)
    print(f"  psgn_direct at q, float32 deltas: peak device memory above its inputs "
          f"{1024 * peak_gib(lambda: psgn.psgn_direct(x, dl)):.1f} MiB (the split terms "
          f"{3 * 2 * dl.numel() / 2**20:.1f} MiB)")
    split = split_record(dl)
    del x, dl

    x, dl = psgn_inputs(r, (b, s, d, d), PSGN_TYPES["f32"])
    got, want = psgn.psgn_direct(x, dl), ref.psgn_ref(x, dl)
    err, rel = psgn_check("psgn_direct slice f32", got, want)
    p = psgn.plan("direct", x.dtype, dl.dtype, s, d, d)
    both = psgn_record(
        "psgn_direct", lambda: psgn.psgn_direct(x, dl), lambda: ref.psgn_ref(x, dl),
        lambda: torch.bmm(x.mT, dl).square().sum((1, 2)),
        err=err, moved=nbytes(x, dl) + 4 * b, flops=2 * b * s * d * d,
        peak=PEAK_BF16, replaces="src/repro/kernels/psgn.py:65", dispatch=p.route,
        pairs=p.pairs)
    print(f"  psgn_direct slice f32 x f32: max rel err {rel:.3e}; plain "
          f"{want.min().item():.6e}..{want.max().item():.6e}")
    psgn_line(f"psgn_direct at q, float32 x and deltas ({d} -> {d}, {p.pairs} term pairs)",
              both)
    del x, dl

    x, dl = psgn_inputs(r, (b, s, d, f), PSGN_TYPES["f32"])
    got, want = psgn.psgn_gram(x, dl), ref.psgn_gram_ref(x, dl)
    err, rel = psgn_check("psgn_gram slice f32", got, want)
    print(f"  psgn_gram slice f32 (B {b}, S {s}, {d} -> {f}): max rel err {rel:.3e}; plain "
          f"{want.min().item():.6e}..{want.max().item():.6e}")
    gram32 = psgn_record(
        "psgn_gram", lambda: psgn.psgn_gram(x, dl), lambda: ref.psgn_gram_ref(x, dl),
        lambda: (torch.bmm(x, x.mT) * torch.bmm(dl, dl.mT)).sum((1, 2)),
        err=err, moved=nbytes(x, dl) + 4 * b, flops=b * s * (s + 1) * (d + f),
        peak=PEAK_F32, replaces="src/repro/kernels/psgn.py:129",
        dispatch=psgn.plan("gram", x.dtype, dl.dtype, s, d, f).route)
    psgn_line(f"psgn_gram at gate/up, float32 ({d} -> {f})", gram32)
    del x, dl
    torch.cuda.empty_cache()
    return [direct, split, gram, fused]


def quant_cases(r) -> dict:
    """The int8 quantisation's edge cases (float32 values): rows not a
    multiple of a 256-row block, C of 1 and ragged, a row over several
    4096-element chunks, an all-zero row, exact .5 ties, rows whose absmax
    is a negative entry, rows holding a NaN or an infinity (a NaN or
    infinite scale, every code 0); and the pod slice's four MLP leaves as
    one row."""
    ties = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5, 3.5]],
                    np.float32)
    neg = r.uniform(-1, 1, (6, 50)).astype(np.float32)
    neg[np.arange(6), r.integers(0, 50, 6)] = -np.arange(2, 8, dtype=np.float32)
    zero = r.standard_normal((5, 40)).astype(np.float32)
    zero[2] = 0.0
    bad = r.standard_normal((5, 4099)).astype(np.float32)
    bad[0, 7], bad[1, 4098], bad[2, 901] = np.nan, np.inf, -np.inf
    bad[3, [1, 4097]] = np.inf, np.nan
    mlp = {f"MLP leaf {shape}": (r.standard_normal((1, int(np.prod(shape)))) * 0.01)
           .astype(np.float32) for shape in ((POD_HIDDEN, POD_D), (POD_HIDDEN,),
                                             (1, POD_HIDDEN), (1,))}
    return {"ragged rows (300, 64)": r.standard_normal((300, 64)).astype(np.float32) * 3,
            "C 1 (7, 1)": r.standard_normal((7, 1)).astype(np.float32),
            "ragged C (33, 4099)": r.standard_normal((33, 4099)).astype(np.float32),
            "one row over 3 chunks + 5": r.standard_normal((1, 3 * 4096 + 5)).astype(np.float32),
            "zero row": zero, "ties": np.concatenate([ties, 2 * ties, ties / 4]),
            "negative max": neg, "NaN and inf rows": bad, **mlp}


def quant_design_cases(flat: torch.Tensor) -> dict:
    """The kernel's two designs at their edges, views of ``flat`` (131072
    values): the one-pass design's longest row (32768) and one either side,
    rows of it, views at an offset of 1 element (no 16-byte aligned
    element) and of 8 (a head before each row's first aligned unit), in
    either design, and ragged rows over the two-pass design."""
    return {"the one-pass design's longest row (1, 32768)": flat[:32768].reshape(1, -1),
            "one less (1, 32767)": flat[:32767].reshape(1, -1),
            "one more: two passes (1, 32769)": flat[:32769].reshape(1, -1),
            "rows at the threshold (4, 32768)": flat.reshape(4, -1),
            "a view at 1 element (1, 32000)": flat[1:32001].reshape(1, -1),
            "a view at 8 elements (5, 13105)": flat[8:65533].reshape(5, -1),
            "a view at 1 element, two passes (1, 65530)": flat[1:65531].reshape(1, -1),
            "a view at 8 elements, two passes (2, 50001)": flat[8:100010].reshape(2, -1),
            "ragged two-pass rows (3, 40001)": flat[:120003].reshape(3, -1)}


def same_scales(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal scales, a NaN counting as equal to a NaN in the same row."""
    nan = a.isnan()
    return torch.equal(nan, b.isnan()) and torch.equal(a[~nan], b[~nan])


def quant_case(name: str, x: torch.Tensor) -> float:
    """The kernel against its plain version: codes and scales EQUAL.
    Returns the largest difference of either (0.0)."""
    q, s = quant.quantize_int8(x)
    torch.cuda.synchronize()
    want_q, want_s = ref.quantize_int8(x)
    flipped = int((q != want_q).sum())
    if flipped or not same_scales(s, want_s):
        raise AssertionError(f"quantize_int8 {name} {x.dtype}: {flipped} codes and "
                             f"{int((s != want_s).sum())} scales differ")
    tag = "f32" if x.dtype == torch.float32 else "bf16"
    finite = want_s.isfinite()
    print(f"  quantize_int8 {tag} {name}: codes and scales bit-exact ({q.numel()} codes"
          + (f"; {int((~finite).sum())} rows with NaN or infinite scales on both"
             if not finite.all() else "") + ")")
    return max((q.int() - want_q.int()).abs().max().item(),
               (s[finite] - want_s[finite]).abs().max().item())


def quant_library(x: torch.Tensor):
    """The library yardstick: amax, divide, round, clamp, cast (timed only)."""
    s = torch.amax(x.abs(), 1).float().clamp_min(1e-12) / 127.0
    return torch.round(x / s[:, None]).clamp(-127, 127).to(torch.int8), s


L2_BYTES = 50e6
#: the longest row ``csrc/quant_int8.cu`` quantises in one pass
ONE_PASS_ROW = 32768


def quant_kernel_record() -> dict:
    """Yi-6B-width gradient leaves: the gate weight per tensor (1, 4096 x
    11008) in float32 (the record: the compressor views a leaf as one row),
    and rowwise (11008, 4096) in float32 and bf16; then the pod slice's
    largest leaf.  Each with its design, the bound (x read once) and, where
    a row outgrows the L2, the floor of a design that reads x twice."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for shape, dtype in (((1, YI.d_model * YI.d_ff), torch.float32),
                         ((YI.d_ff, YI.d_model), torch.float32),
                         ((YI.d_ff, YI.d_model), torch.bfloat16),
                         ((1, POD_HIDDEN * POD_D), torch.float32)):
        x = (torch.randn(shape, generator=gen, device="cuda") * 0.02).to(dtype)
        err = quant_case(f"Yi-6B leaf {shape}" if shape[1] != POD_HIDDEN * POD_D
                         else f"pod leaf {shape}", x)
        ms = timed_ms(lambda: quant.quantize_int8(x))
        device_ms = timed_ms(lambda: quant.quantize_int8(x), spin=True)
        plain_ms = timed_ms(lambda: ref.quantize_int8(x))
        library_ms = timed_ms(lambda: quant_library(x))
        # x read once, the codes and the scales written once
        bound_ms, by = bound(nbytes(x) + x.numel() + 4 * shape[0], 0.0)
        row_bytes = nbytes(x) // shape[0]
        floor = (f"; two-read floor {1e3 * (2 * nbytes(x) + x.numel()) / PEAK_BYTES:.4f} ms "
                 f"(a row of {row_bytes / 1e6:.1f} MB outgrows the L2)"
                 if row_bytes > L2_BYTES else "")
        tag = "f32" if dtype == torch.float32 else "bf16"
        design = "one pass" if shape[1] <= ONE_PASS_ROW else "two passes"
        print(f"  quantize_int8 {tag} {shape} [{design}]: {ms:.4f} ms ({device_ms:.4f} on the "
              f"card alone; plain {plain_ms:.4f}, library {library_ms:.4f}); bound "
              f"{bound_ms:.4f} ms by {by}, {100 * bound_ms / ms:.1f}% of it ("
              f"{100 * bound_ms / device_ms:.1f}% alone){floor}")
        rows.append((err, ms, device_ms, plain_ms, library_ms, bound_ms, by))
        del x
    err, ms, device_ms, plain_ms, library_ms, bound_ms, by = rows[0]
    return {"name": "quantize_int8", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/quant_int8.cu",
            "replaces": "src/repro/kernels/quant.py:20", "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": library_ms, "device_ms": device_ms}


def kernels_phase() -> list[dict]:
    phase("3. kernels against their plain versions (TF32 off)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r = np.random.default_rng(0)
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        chunk_case(f"{tag} n_rep 1, softcap 30, ragged C 23 / Sk 71",
                   chunk_inputs(r, dtype, b=2, c=23, prior_real=40, prior_blocks=3,
                                blk=16, h=4, kv=4, hd=64), softcap=30.0)
        chunk_case(f"{tag} n_rep 8, window 6, padded rows at -(2**30)",
                   chunk_inputs(r, dtype, b=1, c=37, prior_real=20, prior_blocks=2,
                                blk=16, h=8, kv=1, hd=128, window=6, pad_rows=5))
        chunk_case(f"{tag} hd 32, no prior",
                   chunk_inputs(r, dtype, b=1, c=9, prior_real=0, prior_blocks=0,
                                blk=16, h=4, kv=2, hd=32))
        decode_case(f"{tag} n_rep 1, softcap 10",
                    decode_inputs(r, dtype, b=5, blk=8, n_max=6, nb=40, kv=4, h=4,
                                  hd=64, max_len=48), softcap=10.0)
        decode_case(f"{tag} n_rep 8",
                    decode_inputs(r, dtype, b=3, blk=16, n_max=5, nb=20, kv=2, h=16,
                                  hd=128, max_len=80))
        decode_case(f"{tag} hd 80 (a thread's outputs over several columns)",
                    decode_inputs(r, dtype, b=3, blk=16, n_max=5, nb=20, kv=2, h=4,
                                  hd=80, max_len=80))
        flash_case(f"{tag} ragged S 37, n_rep 1, softcap 30",
                   flash_inputs(r, dtype, b=2, s=37, h=4, kv=4, hd=64, softcap=30.0))
        flash_case(f"{tag} ragged S 300, n_rep 8",
                   flash_inputs(r, dtype, b=1, s=300, h=16, kv=2, hd=128))
        flash_case(f"{tag} window 40 across tiles, softcap 20",
                   flash_inputs(r, dtype, b=1, s=150, h=8, kv=2, hd=128, window=40,
                                softcap=20.0))
        flash_case(f"{tag} a single tile (S 16), hd 32",
                   flash_inputs(r, dtype, b=2, s=16, h=4, kv=2, hd=32))
    tc_attention_cases(r)
    decode_split_cases(r)
    for tag, dtypes in PSGN_TYPES.items():
        for shape in ((1, 37, 19, 23), (4, 33, 7, 130), (1, 300, 130, 260),
                      (2, 129, 257, 129), (3, 1, 5, 9)):
            psgn_case(f"{tag} (B, S, Din, Dout) {shape}", shape, dtypes, r)
    # the tensor-core route: bf16, widths multiples of 8 at the FMA cases'
    # edges, ragged 64-position stages and 128-position tiles, ragged
    # 128- and 256-wide tiles, one box
    for shape in ((1, 37, 24, 24), (4, 33, 8, 136), (1, 300, 136, 264),
                  (2, 129, 264, 136), (3, 1, 8, 16), (2, 2049, 4104, 264)):
        psgn_case(f"bf16 (B, S, Din, Dout) {shape}", shape, PSGN_TYPES["bf16"], r)
    # the split route: a float32 operand at widths that are multiples of 8
    for tag in ("bf16 x f32", "f32 x bf16", "f32"):
        for shape in ((1, 37, 24, 24), (4, 33, 8, 136), (1, 300, 136, 264), (3, 1, 8, 16),
                      (2, 2049, 4104, 264)):
            psgn_case(f"{tag} (B, S, Din, Dout) {shape}", shape, PSGN_TYPES[tag], r)
    sass_hgmma()
    for dtype in (torch.float32, torch.bfloat16):
        for name, x32 in quant_cases(r).items():
            quant_case(name, torch.from_numpy(x32).to("cuda", dtype))
        flat = torch.from_numpy(r.standard_normal(1 << 17).astype(np.float32)).to("cuda", dtype)
        for name, x in quant_design_cases(flat).items():
            quant_case(name, x)
    records = [chunk_kernel_record(r), decode_kernel_record(r), *flash_kernel_records(r),
               *psgn_kernel_records(r), quant_kernel_record()]
    torch.cuda.empty_cache()
    for rec in records:
        lib = "none" if rec["library_ms"] is None else f"{rec['library_ms']:.4f}"
        print(f"  {rec['name']}: {rec['ms']:.4f} ms (plain {rec['plain_ms']:.4f}, "
              f"library {lib}); bound {rec['bound_ms']:.4f} ms by "
              f"{rec['bound_by']}, {100 * rec['bound_ms'] / rec['ms']:.1f}% of it")
    return records


# ---------------------------------------------------------------------------
# phase 4: the slice at full width
# ---------------------------------------------------------------------------


def slice_requests(vocab: int, seed: int = 0):
    """8 prompts of 64-700 tokens; the last two share their first 256 real
    tokens (and, at one length, their left padding), so the second adopts
    the first's registered blocks."""
    r = np.random.default_rng(seed)
    prefix = r.integers(1, vocab, size=256)
    lens = [64, 700, 150, 333, 96, 512]
    reqs = [r.integers(1, vocab, size=n) for n in lens]
    reqs += [np.concatenate([prefix, r.integers(1, vocab, size=144)]) for _ in range(2)]
    return [Request(prompt=p.astype(np.int32), max_new_tokens=32) for p in reqs]


def full_width_phase() -> dict:
    phase("4. Yi-6B, 32 layers, bf16, served through repro_torch.serve.ServeEngine")
    cfg = YI
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tf.init_params(cfg, gen, "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"  init: {n_params / 1e9:.3f} B parameters in {time.perf_counter() - t0:.2f} s")
    engine = ServeEngine(cfg, params, device="cuda", max_slots=8, max_seq=2048,
                         block_size=16, prompt_granule=16, prefill_chunk=256,
                         prefix_sharing=True)
    print(f"  pool: {engine.pool.num_blocks} blocks of 16 tokens, "
          f"{sum(x.numel() * x.element_size() for leaf in engine._pages.values() for x in leaf.values()) / 2**30:.2f} GiB")
    reqs = slice_requests(cfg.vocab_size)

    # no logits may be NaN: flag them on the device, read once at the end
    nan_flags = []
    orig_decode, orig_chunk = tf.decode_step, tf.prefill_chunk

    def decode_checked(*a, **kw):
        out = orig_decode(*a, **kw)
        nan_flags.append(torch.isnan(out[0]).any())
        return out

    def chunk_checked(*a, **kw):
        out = orig_chunk(*a, **kw)
        nan_flags.append(torch.isnan(out[0]).any())
        return out

    tf.decode_step, tf.prefill_chunk = decode_checked, chunk_checked
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        t_start = time.perf_counter()
        rids = [engine.submit(q) for q in reqs[:-1]]
        steps = []  # (seconds, chunks run, decoded?) per engine step
        sharer = rids[-1]

        def step():
            c0, s0 = engine.stats.prefill_chunks, engine.stats.steps
            t = time.perf_counter()
            more = engine.step()
            torch.cuda.synchronize()
            steps.append((time.perf_counter() - t, engine.stats.prefill_chunks - c0,
                          engine.stats.steps - s0))
            return more

        # the second sharer arrives once the first has registered its prompt
        # (it decodes from then on)
        while sharer not in {rid for _, rid in engine.sched.running_slots()}:
            step()
        rids.append(engine.submit(reqs[-1]))
        while step():
            pass
        engine.pool.check()
        wall = time.perf_counter() - t_start
        counts = kernels.launch_counts()
    finally:
        tf.decode_step, tf.prefill_chunk = orig_decode, orig_chunk
    results = [engine.result(rid) for rid in rids]
    st = engine.stats
    if any(bool(f) for f in nan_flags):
        raise AssertionError("NaN logits on the full-width path")
    if [len(res.tokens) for res in results] != [32] * len(reqs):
        raise AssertionError(f"unfinished requests: {[len(x.tokens) for x in results]}")
    want = {"chunk_attention": st.prefill_chunks * cfg.num_layers,
            "paged_decode_attention": st.steps * cfg.num_layers,
            "flash_dq": 0, "flash_dkv": 0, **NO_PSGN}
    if counts != want or 0 in (want["chunk_attention"], want["paged_decode_attention"]):
        raise AssertionError(f"kernel launches {counts}, expected {want}")
    attn_routes(counts, tc=True, what="serving")
    if st.shared_blocks == 0:
        raise AssertionError("the shared prefix was not adopted")
    decode_only = [s for s, c, d in steps if c == 0 and d == 1]
    decode_ms = 1e3 * statistics.median(decode_only)
    chunk_ms = [1e3 * (s - (decode_ms / 1e3 if d else 0.0)) / c
                for s, c, d in steps if c > 0]
    print(f"  launches: {counts} (= 32 x {st.prefill_chunks} chunks, "
          f"32 x {st.steps} decode steps, no backward); attention routes "
          f"{attention_routes()}; the last decode step's plan "
          f"{kattn.paged_decode_attention.splits} splits")
    print(f"  decode step: median {decode_ms:.2f} ms over {len(decode_only)} "
          f"decode-only steps (batch bucket {st.buckets})")
    print(f"  prefill chunk: median {statistics.median(chunk_ms):.2f} ms over "
          f"{len(chunk_ms)} steps with chunks (decode share subtracted)")
    print(f"  end to end: {st.tokens} tokens in {wall:.2f} s = "
          f"{st.tokens / wall:.1f} tokens/s; prompt tokens "
          f"{sum(len(q.prompt) for q in reqs)}")
    print(f"  peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"  stats: {json.dumps(st.as_dict())}")
    print(f"  first request's tokens: {results[0].tokens.tolist()[:12]} ...")
    del engine, params
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 5: card against CPU
# ---------------------------------------------------------------------------


def card_vs_cpu_phase() -> None:
    phase("5. reduced Yi-6B, float32: card (kernels) against CPU (plain versions)")
    cfg = get_config("yi-6b", reduced=True).replace(
        num_layers=4, d_model=256, num_heads=4, num_kv_heads=2, d_ff=512)
    cpu = tf.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    card = tf.build(cfg, "cuda")
    card.load_state_dict(cpu.state_dict())
    # first logits: one whole-prompt chunk into fresh pools on both devices
    r = np.random.default_rng(9)
    toks = torch.from_numpy(r.integers(1, cfg.vocab_size, size=(1, 48)))
    logits = {}
    for dev, model in (("cuda", card), ("cpu", cpu)):
        pages = tf.init_pages(cfg, 8, 16, device=dev)
        row = {"len": torch.zeros(1, dtype=torch.int32, device=dev)}
        out, _, _ = tf.prefill_chunk(cfg, model, row, pages, {"tokens": toks.to(dev)},
                                     0, torch.zeros(0, dtype=torch.long, device=dev),
                                     torch.arange(1, 4, device=dev))
        logits[dev] = out.cpu()
    err = (logits["cuda"] - logits["cpu"]).abs().max().item()
    if err > 1e-4:
        raise AssertionError(f"first logits differ by {err:.3e} > 1e-4")
    reqs = [Request(prompt=r.integers(1, cfg.vocab_size, size=n).astype(np.int32),
                    max_new_tokens=12) for n in (7, 40, 23, 64)]
    kw = dict(max_slots=4, max_seq=128, block_size=16, prompt_granule=16,
              prefill_chunk=32)
    kernels.reset_launch_counts()
    out_card = ServeEngine(cfg, card, device="cuda", **kw).generate(reqs)
    launched = kernels.launch_counts()
    out_cpu = ServeEngine(cfg, cpu, device="cpu", **kw).generate(reqs)
    tc = [o.tokens.tolist() for o in out_card]
    if tc != [o.tokens.tolist() for o in out_cpu]:
        raise AssertionError("card and CPU tokens differ")
    if not (launched["chunk_attention"] and launched["paged_decode_attention"]):
        raise AssertionError(f"the card run did not use the kernels: {launched}")
    attn_routes(launched, tc=False, what="float32 serving")
    print(f"  first logits max abs diff {err:.3e} (tol 1e-4); tokens identical "
          f"over {sum(len(t) for t in tc)} tokens; card launches {launched}")


# ---------------------------------------------------------------------------
# phase 6: training at full width
# ---------------------------------------------------------------------------

TRAIN_LAYERS, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS, TRAIN_LR = 8, 2048, 2, 12, 0.02


def train_phase() -> dict:
    phase(f"6. Yi-6B widths, {TRAIN_LAYERS} of 32 layers, bf16, remat: DiveBatch "
          f"training through repro_torch.train.StepEngine.for_lm")
    cfg = YI.replace(num_layers=TRAIN_LAYERS)
    t0 = time.perf_counter()
    params = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    n_matmul = n_params - params.embed.weight.numel()  # the lookup does no products
    print(f"  init: {n_params / 1e9:.3f} B parameters ({n_matmul / 1e9:.3f} B in "
          f"matrix products) in {time.perf_counter() - t0:.2f} s")
    program = train_lm.make_program("divebatch", m0=4, m_max=16, delta=0.5,
                                    granule=TRAIN_MICRO, lr=TRAIN_LR, tick_every=4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out = train_lm.train(cfg, params, program, steps=TRAIN_STEPS, seq_len=TRAIN_SEQ,
                         micro_batch=TRAIN_MICRO, attn_impl="pallas",
                         log=lambda line: print("  " + line))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    recs = out["records"]
    for rec in recs:
        print(f"  step {rec['step']:2d}: batch {rec['batch']:2d} ({rec['num_micro']} "
              f"microbatches), loss {rec['loss']:.5f}, {1e3 * rec['seconds']:.1f} ms")
    for rec in recs:
        if "diversity" in rec:
            print(f"  tick at step {rec['step']}: Delta {rec['diversity']:.6f}, gns "
                  f"{rec['gns']:.6g}, batch {rec['batch']} -> {rec['next_batch']}")
    if not all(np.isfinite(rec["loss"]) for rec in recs):
        raise AssertionError(f"non-finite loss: {[rec['loss'] for rec in recs]}")
    n_micro = sum(rec["num_micro"] for rec in recs)
    layers = cfg.num_layers
    want = {"chunk_attention": 2 * layers * n_micro, "paged_decode_attention": 0,
            "flash_dq": layers * n_micro, "flash_dkv": layers * n_micro, **NO_PSGN}
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, expected {want}")
    attn_routes(counts, tc=True, what="training")
    print(f"  launches: {counts} (= {2 * layers}, {layers}, {layers} x {n_micro} "
          f"microbatches); attention routes {attention_routes()}")
    hd, h = cfg.resolved_head_dim, cfg.num_heads
    pairs = TRAIN_SEQ * (TRAIN_SEQ + 1) // 2

    def model_flops(batch: int) -> float:
        # 6 N per token for the products, plus causal attention: 2 products
        # forward and 4 backward of 2 * hd per (row, key) pair per head
        return (6 * n_matmul * batch * TRAIN_SEQ
                + 12 * hd * h * layers * batch * pairs)

    steady = recs[1:]
    secs = [rec["seconds"] for rec in steady]
    flops = [model_flops(rec["batch"]) for rec in steady]
    tokens = [rec["batch"] * TRAIN_SEQ for rec in steady]
    print(f"  per-step ms: median {1e3 * statistics.median(secs):.1f} over steps 2-"
          f"{TRAIN_STEPS}; by batch: " + ", ".join(
              f"{m}: {1e3 * statistics.median([x['seconds'] for x in steady if x['batch'] == m]):.1f}"
              for m in sorted({x['batch'] for x in steady})))
    print(f"  tokens/s: {sum(tokens) / sum(secs):.1f} over steps 2-{TRAIN_STEPS}")
    print(f"  model FLOPs per step: " + ", ".join(
        f"batch {m}: {model_flops(m):.4e}" for m in sorted({x['batch'] for x in steady}))
          + f"; achieved {sum(flops) / sum(secs) / 1e12:.2f} TFLOP/s = "
          f"{100 * sum(flops) / sum(secs) / PEAK_BF16:.2f}% of 989 TFLOP/s")
    print(f"  peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"  stats: {json.dumps(out['engine'].stats.as_dict())}")
    del out, params
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# phase 7: training, card against CPU
# ---------------------------------------------------------------------------


def train_card_vs_cpu_phase() -> None:
    phase("7. reduced Yi-6B, float32: training on the card (kernels) against the CPU "
          "(plain versions)")
    # hd 64: the reduced config's hd 16 has no kernel instance
    cfg = get_config("yi-6b", reduced=True).replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, d_ff=512, remat=True,
        attn_impl="pallas")
    cpu = tf.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    card = tf.build(cfg, "cuda")
    card.load_state_dict(cpu.state_dict())
    runs = {}
    for dev, model in (("cuda", card), ("cpu", cpu)):
        program = train_lm.make_program("divebatch", m0=4, m_max=16, delta=0.5,
                                        granule=2, lr=0.05, tick_every=2)
        kernels.reset_launch_counts()
        out = train_lm.train(cfg, model, program, steps=6, seq_len=64, micro_batch=2,
                             attn_impl="pallas", log=lambda line: None)
        runs[dev] = (out, kernels.launch_counts())
        if dev == "cuda":
            attn_routes(runs[dev][1], tc=False, what="float32 training")
    (card_out, card_counts), (cpu_out, cpu_counts) = runs["cuda"], runs["cpu"]
    losses = {d: np.array([x["loss"] for x in o["records"]]) for d, (o, _) in runs.items()}
    rel = float(np.max(np.abs(losses["cuda"] - losses["cpu"]) / np.abs(losses["cpu"])))
    if rel > 1e-4:
        raise AssertionError(f"losses differ by {rel:.3e} relative > 1e-4: {losses}")
    err = max((a.detach().cpu() - b.detach()).abs().max().item()
              for a, b in zip(card.parameters(), cpu.parameters()))
    if err > 1e-4:
        raise AssertionError(f"parameters differ by {err:.3e} > 1e-4")
    sched = {d: [x["batch"] for x in o["records"]] for d, (o, _) in runs.items()}
    buckets = {d: o["engine"].stats.buckets for d, (o, _) in runs.items()}
    if sched["cuda"] != sched["cpu"] or buckets["cuda"] != buckets["cpu"]:
        raise AssertionError(f"batch schedules {sched} / buckets {buckets} differ")
    if any(card_counts[k] == 0 for k in ("chunk_attention", "flash_dq", "flash_dkv")) \
            or any(cpu_counts.values()):
        raise AssertionError(f"launches: card {card_counts}, CPU {cpu_counts}")
    print(f"  losses within {rel:.3e} relative (tol 1e-4), parameters within {err:.3e} "
          f"(tol 1e-4); batch schedule {sched['cuda']}, buckets {buckets['cuda']} on "
          f"both; card launches {card_counts}")


# ---------------------------------------------------------------------------
# phase 8: the gram tier at full width
# ---------------------------------------------------------------------------

GRAM_STEPS, GRAM_DELTA = 8, 2.0


def gram_engine(cfg, optimizer, seq: int, micro_batch: int, device) -> StepEngine:
    """The hand-built gram-tier engine: probes from
    ``repro_torch.models.probes`` on every dense layer."""

    def build(num_micro: int, tier: str):
        return make_train_step(
            cfg, optimizer, num_micro, estimator=tier,
            probe_loss=lambda p, pr, b: probes.loss_with_probes(cfg, p, pr, b),
            probe_specs=lambda p, bsz: probes.probe_specs(cfg, bsz, seq, device=device))

    engine = StepEngine(build, lm_bucket_of(micro_batch))
    engine.tier = "gram"
    return engine


def timed_s(fn):
    """(result, seconds) of ``fn()`` on the host clock, the card drained
    before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def peak_gib(fn) -> float:
    """The device memory ``fn()`` allocates at its peak above what was
    allocated before it, GiB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**30


def stacked_groups(acts, pgrads, scale):
    """The fused groups as ``persample_sq_norm_tree`` ran them before the
    layer table: each group stacked, then one ``psgn_fused``."""
    for key, names in ops.group_layers(acts, pgrads).items():
        if key[0] != "solo" and len(names) >= 2:
            psgn.psgn_fused(torch.stack([acts[n] for n in names]),
                            torch.stack([pgrads[n] * scale for n in names]))


def gram_train_phase() -> tuple[dict, dict]:
    """Returns the launch counts of the training run and of the standalone
    ``persample_sq_norms_gram`` call."""
    phase(f"8. Yi-6B widths, {TRAIN_LAYERS} of 32 layers, bf16, remat: gram-tier DiveBatch "
          f"through a hand-built tiered StepEngine")
    cfg = YI.replace(num_layers=TRAIN_LAYERS, attn_impl="pallas")
    params = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    print(f"  coverage of the probes: {probes.coverage(cfg):.4f} of the parameters")
    engine = gram_engine(cfg, sgd(momentum=0.9), TRAIN_SEQ, TRAIN_MICRO, "cuda")
    program = train_lm.make_program("divebatch", m0=4, m_max=8, delta=GRAM_DELTA,
                                    granule=TRAIN_MICRO, lr=TRAIN_LR, tick_every=4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    out = train_lm.train(cfg, params, program, steps=GRAM_STEPS, seq_len=TRAIN_SEQ,
                         micro_batch=TRAIN_MICRO, engine=engine, estimator="gram",
                         log=lambda line: print("  " + line))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    recs = out["records"]
    for rec in recs:
        print(f"  step {rec['step']:2d}: batch {rec['batch']:2d} ({rec['num_micro']} "
              f"microbatches), loss {rec['loss']:.5f}, {1e3 * rec['seconds']:.1f} ms")
    for rec in recs:
        if "diversity" in rec:
            print(f"  tick at step {rec['step']}: Delta {rec['diversity']:.6f}, gns "
                  f"{rec['gns']:.6g}, batch {rec['batch']} -> {rec['next_batch']}")
    if not all(np.isfinite(rec["loss"]) for rec in recs):
        raise AssertionError(f"non-finite loss: {[rec['loss'] for rec in recs]}")
    if len({rec["batch"] for rec in recs}) < 2:
        raise AssertionError(f"no resize: {[rec['batch'] for rec in recs]}")
    n_micro = sum(rec["num_micro"] for rec in recs)
    layers = cfg.num_layers
    want = {"chunk_attention": 2 * layers * n_micro, "paged_decode_attention": 0,
            "flash_dq": layers * n_micro, "flash_dkv": layers * n_micro,
            "psgn_direct": 0, "psgn_gram": 3 * layers * n_micro, "psgn_fused": 2 * n_micro,
            "psgn_split": 0, "quantize_int8": 0}
    if counts != want:
        raise AssertionError(f"kernel launches {counts}, expected {want}")
    print(f"  launches: {counts} (= {2 * layers}, {layers}, {layers}, 0 direct, "
          f"{3 * layers} gram, 2 fused x {n_micro} microbatches)")
    # bf16 activations and probe gradients at widths that are multiples of
    # 8: every psgn launch of the tier takes the tensor cores
    attn_routes(counts, tc=True, what="gram-tier training")
    routes = kernels.route_counts()
    want_routes = {"chunk_attention": {"tc": want["chunk_attention"], "fma": 0},
                   "flash_dq": {"tc": want["flash_dq"], "fma": 0},
                   "flash_dkv": {"tc": want["flash_dkv"], "fma": 0},
                   "psgn_direct": {"tc": 0, "split": 0, "fma": 0},
                   "psgn_gram": {"tc": want["psgn_gram"], "fma": 0},
                   "psgn_fused": {"tc": want["psgn_fused"], "split": 0, "fma": 0}}
    if routes != want_routes:
        raise AssertionError(f"psgn routes {routes}, expected {want_routes}")
    print(f"  routes: {routes}")
    steady = recs[1:]
    secs = [rec["seconds"] for rec in steady]
    print(f"  per-step ms: median {1e3 * statistics.median(secs):.1f} over steps 2-"
          f"{GRAM_STEPS}; by batch: " + ", ".join(
              f"{m}: {1e3 * statistics.median([x['seconds'] for x in steady if x['batch'] == m]):.1f}"
              for m in sorted({x['batch'] for x in steady})))
    print(f"  tokens/s: {sum(rec['batch'] * TRAIN_SEQ for rec in steady) / sum(secs):.1f} "
          f"over steps 2-{GRAM_STEPS}")
    print(f"  peak device memory: {peak:.2f} GiB")
    print(f"  stats: {json.dumps(engine.stats.as_dict())}")

    # one microbatch, its parts timed apart: the main pass (loss and
    # gradient), the probe pass, the psgn kernels over the probed layers
    mb = {k: torch.from_numpy(v).to("cuda")
          for k, v in TokenStream(cfg.vocab_size, seed=1).batch(
              0, TRAIN_MICRO, TRAIN_SEQ).items()}
    state_params = list(params.parameters())
    hook = lambda p, pr, b: probes.loss_with_probes(cfg, p, pr, b)  # noqa: E731
    specs = probes.probe_specs(cfg, TRAIN_MICRO, TRAIN_SEQ, device="cuda")
    split = {}
    for _ in range(2):  # the second round is the one kept
        _, split["main pass"] = timed_s(lambda: torch.autograd.grad(
            tf.loss_fn(cfg, params, mb)[0], state_params))
        (_, acts, pgrads), split["probe pass"] = timed_s(
            lambda: probes.probe_grads(hook, params, specs, mb))
        tree, split["psgn kernels"] = timed_s(
            lambda: ops.persample_sq_norm_tree(acts, pgrads, scale=float(TRAIN_MICRO)))
    print("  one gram-tier microbatch: " + ", ".join(
        f"{k} {1e3 * v:.1f} ms" for k, v in split.items())
        + f"; total {1e3 * sum(split.values()):.1f} ms")
    # where the step's memory peak is: each part's own peak above what is
    # allocated before it (weights, optimizer state and, for the psgn
    # kernels, the probe pass's activations and gradients)
    peaks = {
        "main pass": peak_gib(lambda: torch.autograd.grad(
            tf.loss_fn(cfg, params, mb)[0], state_params)),
        "probe pass": peak_gib(lambda: probes.probe_grads(hook, params, specs, mb)),
        "psgn kernels": peak_gib(
            lambda: ops.persample_sq_norm_tree(acts, pgrads, scale=float(TRAIN_MICRO))),
        "psgn kernels, groups stacked": peak_gib(
            lambda: stacked_groups(acts, pgrads, float(TRAIN_MICRO)))}
    print(f"  resident before the parts {torch.cuda.memory_allocated() / 2**30:.2f} GiB; "
          "peak above it: " + ", ".join(f"{k} {v:.2f} GiB" for k, v in peaks.items()))

    # the standalone entry point: every layer alone, so q, k, v, o go direct
    kernels.reset_launch_counts()
    alone, alone_s = timed_s(lambda: probes.persample_sq_norms_gram(cfg, params, mb))
    counts_alone = kernels.launch_counts()
    want_alone = {**{k: 0 for k in counts_alone}, "psgn_direct": 4 * layers,
                  "psgn_gram": 3 * layers, "psgn_split": 4 * layers}
    if counts_alone != want_alone:
        raise AssertionError(f"persample_sq_norms_gram launches {counts_alone}, "
                             f"expected {want_alone}")
    # its float32 deltas take the split route for direct (each delta split
    # once), the FMA kernel for gram: the check below holds them against the
    # tree's tensor-core launches on the same activations and gradients
    routes_alone = kernels.route_counts()
    want_routes = {"chunk_attention": {"tc": 0, "fma": 0},
                   "flash_dq": {"tc": 0, "fma": 0},
                   "flash_dkv": {"tc": 0, "fma": 0},
                   "psgn_direct": {"tc": 0, "split": 4 * layers, "fma": 0},
                   "psgn_gram": {"tc": 0, "fma": 3 * layers},
                   "psgn_fused": {"tc": 0, "split": 0, "fma": 0}}
    if routes_alone != want_routes:
        raise AssertionError(f"persample_sq_norms_gram routes {routes_alone}, "
                             f"expected {want_routes}")
    rel = ((alone - tree).abs() / tree.abs()).max().item()
    if rel > PSGN_TOL or not torch.isfinite(alone).all():
        raise AssertionError(f"split and FMA routes against tensor cores: {alone.tolist()} vs "
                             f"{tree.tolist()}")
    print(f"  persample_sq_norms_gram (split route: {4 * layers} direct, {4 * layers} splits; "
          f"FMA: {3 * layers} gram): {alone.tolist()}; the tree (tensor cores: fused, gram) "
          f"{tree.tolist()}: max rel diff {rel:.3e} (tol {PSGN_TOL})")
    alone_peak = peak_gib(lambda: probes.persample_sq_norms_gram(cfg, params, mb))
    print(f"  persample_sq_norms_gram: {1e3 * alone_s:.1f} ms (host clock, its probe pass "
          f"included); peak device memory above the resident {alone_peak:.2f} GiB")
    del out, params, acts, pgrads, engine
    torch.cuda.empty_cache()
    return counts, counts_alone


# ---------------------------------------------------------------------------
# phase 9: the gram tier, card against CPU
# ---------------------------------------------------------------------------


def gram_card_vs_cpu_phase() -> None:
    phase("9. reduced Yi-6B, float32: gram-tier training on the card (kernels) against "
          "the CPU (plain versions)")
    # hd 64 and d_ff 1024 at S 128: every layer takes the dispatch Yi-6B
    # takes at S 2048 (q/o and k/v fused, gate/up/down gram)
    cfg = get_config("yi-6b", reduced=True).replace(
        num_layers=2, d_model=256, num_heads=4, num_kv_heads=2, d_ff=1024, remat=True,
        attn_impl="pallas")
    seq = 128
    cpu = tf.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    card = tf.build(cfg, "cuda")
    card.load_state_dict(cpu.state_dict())
    runs = {}
    for dev, model in (("cuda", card), ("cpu", cpu)):
        program = train_lm.make_program("divebatch", m0=4, m_max=16, delta=0.5,
                                        granule=2, lr=0.05, tick_every=2)
        engine = gram_engine(cfg, sgd(momentum=0.9), seq, 2, dev)
        kernels.reset_launch_counts()
        out = train_lm.train(cfg, model, program, steps=5, seq_len=seq, micro_batch=2,
                             engine=engine, estimator="gram", log=lambda line: None)
        runs[dev] = (out, kernels.launch_counts())
        if dev == "cuda":
            attn_routes(runs[dev][1], tc=False, what="float32 gram-tier training")
            fused_routes = kernels.route_counts()["psgn_fused"]
    (card_out, card_counts), (cpu_out, cpu_counts) = runs["cuda"], runs["cpu"]

    def rel_err(a, b) -> float:
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.max(np.abs(a - b) / np.abs(b)))

    losses = {d: [x["loss"] for x in o["records"]] for d, (o, _) in runs.items()}
    deltas = {d: [x["diversity"] for x in o["records"] if "diversity" in x]
              for d, (o, _) in runs.items()}
    sq = {d: o["state"].div_state.sq_norm_sum.item() for d, (o, _) in runs.items()}
    rels = {"losses": rel_err(losses["cuda"], losses["cpu"]),
            "Delta at ticks": rel_err(deltas["cuda"], deltas["cpu"]),
            "sq_norm_sum": rel_err([sq["cuda"]], [sq["cpu"]])}
    if max(rels.values()) > 1e-4:
        raise AssertionError(f"card against CPU: {rels} > 1e-4 relative")
    err = max((a.detach().cpu() - b.detach()).abs().max().item()
              for a, b in zip(card.parameters(), cpu.parameters()))
    if err > 1e-4:
        raise AssertionError(f"parameters differ by {err:.3e} > 1e-4")
    sched = {d: [x["batch"] for x in o["records"]] for d, (o, _) in runs.items()}
    if sched["cuda"] != sched["cpu"]:
        raise AssertionError(f"batch schedules {sched} differ")
    n_micro = sum(x["num_micro"] for x in card_out["records"])
    # float32 x and deltas: each fused group on the split route, x and
    # delta split once each
    if (card_counts["psgn_fused"], card_counts["psgn_gram"], card_counts["psgn_split"]) != \
            (2 * n_micro, 6 * n_micro, 4 * n_micro) or card_counts["psgn_direct"] \
            or any(cpu_counts.values()) \
            or fused_routes != {"tc": 0, "split": 2 * n_micro, "fma": 0}:
        raise AssertionError(f"launches: card {card_counts}, fused routes {fused_routes}, "
                             f"CPU {cpu_counts}")
    print("  " + ", ".join(f"{k} within {v:.3e} relative" for k, v in rels.items())
          + f" (tol 1e-4); parameters within {err:.3e} (tol 1e-4); batch schedule "
          f"{sched['cuda']} on both; card launches {card_counts}; psgn_fused routes "
          f"{fused_routes}")


# ---------------------------------------------------------------------------
# phase 10: the paper's Trainer on a two-pod PodLadder
# ---------------------------------------------------------------------------

# the paper's synthetic non-convex task (repro/launch/train.py): n 20000, d
# 512, the 2-layer MLP with hidden d // 8; DiveBatch on the moment tier from
# m0 64 (rung 2, pod 0 only) with the reference launcher's delta 0.1 and lr
# 0.1.  At the first epoch boundary Delta is near 1, so m = min(128, 0.1 x
# 16000 x Delta) = 128, and the run moves onto rung 3 (2 pods x 4)
POD_N, POD_D, POD_HIDDEN, POD_LR = 20_000, 512, 64, 0.1
POD_M0, POD_M_MAX, POD_DELTA = 64, 128, 0.1


def pod_trainer(device, seed: int = 0) -> Trainer:
    train, val, _ = sigmoid_synthetic(n=POD_N, d=POD_D, seed=seed)
    params = small.mlp_init(torch.Generator().manual_seed(seed), POD_D, POD_HIDDEN,
                            device=device)
    fns = ModelFns(batch_loss=small.mlp_batch_loss, example_loss=small.mlp_loss,
                   metrics=lambda p, b: {"acc": small.mlp_accuracy(p, b)})
    program = AdaptationProgram(
        DiveBatchPolicy(POD_M0, POD_M_MAX, POD_DELTA, dataset_size=len(train), granule=16),
        POD_LR, estimator="moment")
    return Trainer(fns, params, sgd(momentum=0.9), program, train, val,
                   estimator="moment", seed=seed,
                   elastic=PodLadder(pods=2, devices=[device] * 8, granule=16))


def run_pod_epochs(trainer: Trainer, epochs: int, log=None) -> list[tuple]:
    """``(batch, rung index, record)`` per epoch: the batch size and rung
    the epoch ran at (a resize applies at the start of the next epoch; the
    record's batch_size is the decision for the next)."""
    out = []
    for _ in range(epochs):
        bsz = trainer.adapt.batch_size
        rec = trainer.run_epoch()
        out.append((bsz, trainer.rung.index, rec))
        if log:
            log(*out[-1])
    return out


def print_epoch(bsz, rung, rec) -> None:
    print(f"  epoch {rec.epoch}: batch {bsz}, rung {rung}, {rec.steps} steps, train loss "
          f"{rec.train_loss:.6f}, val loss {rec.val_loss:.6f}, val acc "
          f"{rec.val_metrics['acc']:.4f}, Delta {rec.diversity:.6f} -> batch "
          f"{rec.batch_size}; {1e3 * rec.wall_s / rec.steps:.3f} ms per step (epoch wall / "
          f"steps)")


def pod_phase() -> dict:
    phase("10. the paper's Trainer on a two-pod PodLadder (8 virtual devices on the card): "
          f"MLP {POD_D} -> {POD_HIDDEN} -> 1 on sigmoid_synthetic(n={POD_N})")
    trainer = pod_trainer("cuda")
    n_leaves = len(list(trainer.params.parameters()))
    numel = sum(p.numel() for p in trainer.params.parameters())
    print(f"  {numel} parameters in {n_leaves} leaves; DiveBatch m0 {POD_M0}, m_max "
          f"{POD_M_MAX}, delta {POD_DELTA}, lr {POD_LR}, momentum 0.9, moment tier; "
          f"ladder {trainer.elastic}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    runs = run_pod_epochs(trainer, 3, print_epoch)
    if runs[-1][1] != 3:
        raise AssertionError(f"the run did not reach the cross-pod rung: {runs}")
    if runs[0][:2] != (POD_M0, 2):
        raise AssertionError(f"the run did not start at batch {POD_M0} on rung 2: {runs}")
    trainer.elastic.health.mark_lost(1)
    src, dst = trainer.demote(note="pod 1 lost")
    if (src, dst) != (3, 2) or trainer.state.err_state is not None:
        raise AssertionError(f"demote gave {src} -> {dst}, residuals "
                             f"{trainer.state.err_state is not None}")
    print(f"  pod 1 lost: demoted rung {src} -> {dst}, residuals dropped")
    runs += run_pod_epochs(trainer, 1, print_epoch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    cross_steps = sum(rec.steps for _, rung, rec in runs
                      if trainer.elastic.rungs[rung].pods > 1)
    want = {k: 0 for k in counts} | {"quantize_int8": 2 * n_leaves * cross_steps}
    if counts != want or cross_steps == 0:
        raise AssertionError(f"kernel launches {counts}, expected {want}")
    if not all(np.isfinite(rec.val_loss) for _, _, rec in runs):
        raise AssertionError(f"non-finite val loss: {runs}")
    if runs[-1][2].val_loss > runs[0][2].val_loss:
        raise AssertionError("the val loss rose over the run")
    print(f"  quantize_int8 launches {counts['quantize_int8']} (= 2 pods x {n_leaves} leaves "
          f"x {cross_steps} cross-pod steps); no other kernel")
    wire = numel + 4 * n_leaves
    print(f"  wire bytes per pod per exchange: {wire} (int8 codes + a float32 scale per "
          f"leaf) against {4 * numel} in float32, {4 * numel / wire:.3f}x fewer")
    print(f"  {len(runs)} epochs in {wall:.2f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**20:.2f} MiB")
    print(f"  stats: {json.dumps(trainer.engine.stats.as_dict())}")
    return counts


# ---------------------------------------------------------------------------
# phase 11: the pod slice, card against CPU
# ---------------------------------------------------------------------------

# limits set from an H100 run (NVIDIA H100 80GB HBM3, 700 W): the losses
# agreed to 5.3e-5 relative, the parameters after 375 steps to 6.372e-3, and
# one exchange from the same state and batch flipped 1 of 65794 codes and
# left the other residuals within 9.4e-5 quanta
POD_LOSS_RTOL = 1e-3
POD_PARAM_ATOL = 1e-2
POD_STEP_FLIPS_MAX = 8
POD_STEP_KEPT_QUANTA = 1e-3


def residual_gap(ours: list, theirs: list, scales: torch.Tensor) -> tuple[int, float]:
    """(codes that flipped, largest residual difference of the others in
    quanta) between stacked per-pod residuals; ``scales`` is (pods, leaves),
    a pod's leaf's quantum.  Codes that agree leave residuals within
    rounding of each other; a flipped code moves one by about a quantum
    (|r| <= quantum / 2 on both sides)."""
    flipped, worst = 0, 0.0
    for i, (a, b) in enumerate(zip(ours, theirs)):
        d = (a.cpu() - b.cpu()).abs() / scales[:, i].reshape((-1,) + (1,) * (a.dim() - 1))
        flipped += int((d > 0.5).sum())
        kept = d[d <= 0.5]
        worst = max(worst, kept.max().item() if kept.numel() else 0.0)
    return flipped, worst


def pod_card_vs_cpu_phase() -> None:
    phase("11. the pod slice on the card ([cuda:0] * 8) against the CPU ([cpu] * 8), "
          "identical weights, 2 epochs")
    runs, scales = {}, {}
    for dev in ("cuda", "cpu"):
        trainer = pod_trainer(dev)
        step = trainer.engine.step

        def capture(state, batch, lr, step=step, dev=dev):
            new, metrics = step(state, batch, lr)
            if "scales" in metrics:
                scales[dev] = metrics["scales"]
            return new, metrics

        trainer.engine.step = capture
        runs[dev] = (trainer, run_pod_epochs(trainer, 2))
    (tc, rc), (tp, rp) = runs["cuda"], runs["cpu"]
    sched = {d: [(bsz, rung, rec.steps) for bsz, rung, rec in r]
             for d, (_, r) in runs.items()}
    if sched["cuda"] != sched["cpu"] or sched["cuda"][-1][1] != 3:
        raise AssertionError(f"schedules (batch, rung, steps) differ: {sched}")
    rels = {}
    for field in ("train_loss", "val_loss"):
        a = np.array([getattr(rec, field) for _, _, rec in rc])
        b = np.array([getattr(rec, field) for _, _, rec in rp])
        rels[field] = float(np.max(np.abs(a - b) / np.abs(b)))
    if max(rels.values()) > POD_LOSS_RTOL:
        raise AssertionError(f"losses differ: {rels} > {POD_LOSS_RTOL} relative")
    flipped, worst_kept = residual_gap(tc.state.err_state, tp.state.err_state,
                                       scales["cpu"])
    perr = max((a.detach().cpu() - b.detach()).abs().max().item()
               for a, b in zip(tc.params.parameters(), tp.params.parameters()))
    if perr > POD_PARAM_ATOL:
        raise AssertionError(f"parameters differ by {perr:.3e} > {POD_PARAM_ATOL}")
    n_res = sum(e.numel() for e in tp.state.err_state)
    # the runs have drifted apart by then; one exchange from the SAME state
    # and batch on both devices shows what a single step makes of rounding
    batch = {k: torch.from_numpy(v)
             for k, v in tp.train_data.get(np.arange(2 * POD_M0)).items()}
    one = {}
    for dev, t in (("cuda", tc), ("cpu", tp)):
        state = place(copy.deepcopy(tp.state), t.rung.plan)
        new, metrics = t.engine.jitted(2 * POD_M0)(state, batch, POD_LR)
        one[dev] = ([e.cpu() for e in new.err_state], metrics["scales"].cpu())
    step_flips, step_kept = residual_gap(one["cuda"][0], one["cpu"][0], one["cpu"][1])
    if step_flips > POD_STEP_FLIPS_MAX or step_kept > POD_STEP_KEPT_QUANTA:
        raise AssertionError(
            f"one exchange from the same state: {step_flips} of {n_res} codes flipped (tol "
            f"{POD_STEP_FLIPS_MAX}), the others' residuals within {step_kept:.3e} quanta "
            f"(tol {POD_STEP_KEPT_QUANTA})")
    print(f"  schedule (batch, rung, steps) {sched['cuda']} on both; train/val losses "
          f"within {rels['train_loss']:.3e} / {rels['val_loss']:.3e} relative (tol "
          f"{POD_LOSS_RTOL}); parameters within {perr:.3e} (tol {POD_PARAM_ATOL}); "
          f"{flipped} of {n_res} codes flipped at the last exchange, the others within "
          f"{worst_kept:.2e} quanta; one exchange from the same state and batch: "
          f"{step_flips} of {n_res} codes flipped (tol {POD_STEP_FLIPS_MAX}), the others' "
          f"residuals within {step_kept:.3e} quanta (tol {POD_STEP_KEPT_QUANTA})")


def main() -> int:
    phase("1. the card")
    if not torch.cuda.is_available():
        print("no CUDA device: this smoke run needs an H100", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, capability "
          f"{torch.cuda.get_device_capability(0)}")

    phase("2. build (nvcc, sm_90a)")
    t0 = time.perf_counter()
    info = _build.build_all()
    print(f"  built in {time.perf_counter() - t0:.1f} s")
    for name, rec in info.items():
        print(f"  {name}: nvcc {rec['seconds']:.1f} s")
        for line in rec["ptxas"]:
            if "Used" in line or ("spill" in line and not line.startswith("0 bytes stack")):
                print(f"    {line}")

    records = kernels_phase()
    serve_counts = full_width_phase()
    card_vs_cpu_phase()
    train_counts = train_phase()
    train_card_vs_cpu_phase()
    gram_counts, alone_counts = gram_train_phase()
    gram_card_vs_cpu_phase()
    pod_counts = pod_phase()
    pod_card_vs_cpu_phase()
    # launches on the main paths: serving (phase 4), training on the moment
    # tier (phase 6), on the gram tier (phase 8), the standalone per-sample
    # norms (phase 8, last) and the pod slice (phase 10)
    paths = {"serving": serve_counts, "training": train_counts,
             "gram-tier training": gram_counts, "persample_sq_norms_gram": alone_counts,
             "pod training": pod_counts}
    for rec in records:
        rec["launches"] = sum(c[rec["name"]] for c in paths.values())
        if rec["launches"] == 0:
            raise AssertionError(f"{rec['name']} was launched on no path")
    print("\n  launches by path: " + "; ".join(f"{k} {v}" for k, v in paths.items()))

    print()
    print(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
