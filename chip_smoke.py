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
     out-of-order pool ids.  bf16 is held at 2e-2 against the plain version
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
     1e-4.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.  It imports nothing of JAX.
"""

from __future__ import annotations

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

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import attention as kattn  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402

# H100 SXM peaks at a 700 W limit (NVIDIA data sheet): HBM3 bytes/s and
# dense bf16 tensor-core FLOP/s
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
YI = get_config("yi-6b")


def phase(name: str) -> None:
    print(f"\n== {name}", flush=True)


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

_FLUSH = None


def timed_ms(fn, iters: int = 10) -> float:
    """Median device time of one call: CUDA events around each call, a
    64 MiB write between calls so the 50 MB L2 starts cold."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        _FLUSH.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(n_bytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / PEAK_BYTES, flops / PEAK_BF16
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def check(name: str, got: torch.Tensor, want: torch.Tensor, dtype) -> float:
    err = (got.float() - want.float()).abs()
    tol = TOL[dtype]
    bad = err > tol + tol * want.float().abs()
    if bad.any() or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: max abs err {err.max().item():.3e} "
                             f"over tolerance {tol} ({int(bad.sum())} elements)")
    return err.max().item()


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
    out, lse = kattn.chunk_attention_fwd(*args, window=inp["window"], softcap=softcap)
    torch.cuda.synchronize()
    want, want_lse = ref.attention_ref_lse(*args, window=inp["window"], softcap=softcap)
    err = check(name, out, want, dtype)
    check(name + " lse", lse, want_lse, dtype)
    print(f"  chunk {name}: max abs err {err:.3e} (tol {TOL[dtype]})")
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
    plain_ms = timed_ms(lambda: ref.attention_ref_lse(*args))
    # library yardstick: SDPA with the same boolean mask, GQA grouping
    rel = inp["q_pos"][:, None].long() - inp["k_pos"][None, :].long()
    mask = ((rel >= 0) & inp["k_valid"][None, :] & (inp["q_pos"][:, None] >= 0))
    qt, kt, vt = (x.transpose(1, 2) for x in (inp["q"], inp["k"], inp["v"]))
    library_ms = timed_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask[None, None], enable_gqa=True))
    pairs = valid_pairs(inp["q_pos"], inp["k_pos"], inp["k_valid"])
    moved = nbytes(*args) + nbytes(inp["q"]) + 256 * h * 4  # + out + lse
    bound_ms, by = bound(moved, 4 * pairs * h * hd)
    return {"name": "chunk_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/chunk_attention.cu",
            "replaces": "src/repro/kernels/attention.py:92",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": library_ms}


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
    ms = timed_ms(lambda: kattn.paged_decode_attention(*args))
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
    return {"name": "paged_decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_decode.cu",
            "replaces": "src/repro/kernels/attention.py:448",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": library_ms}


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
    records = [chunk_kernel_record(r), decode_kernel_record(r)]
    for rec in records:
        print(f"  {rec['name']}: {rec['ms']:.4f} ms (plain {rec['plain_ms']:.4f}, "
              f"library {rec['library_ms']:.4f}); bound {rec['bound_ms']:.4f} ms by "
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
        kattn.reset_launch_counts()
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
        counts = kattn.launch_counts()
    finally:
        tf.decode_step, tf.prefill_chunk = orig_decode, orig_chunk
    results = [engine.result(rid) for rid in rids]
    st = engine.stats
    if any(bool(f) for f in nan_flags):
        raise AssertionError("NaN logits on the full-width path")
    if [len(res.tokens) for res in results] != [32] * len(reqs):
        raise AssertionError(f"unfinished requests: {[len(x.tokens) for x in results]}")
    want = {"chunk_attention": st.prefill_chunks * cfg.num_layers,
            "paged_decode_attention": st.steps * cfg.num_layers}
    if counts != want or 0 in counts.values():
        raise AssertionError(f"kernel launches {counts}, expected {want}")
    if st.shared_blocks == 0:
        raise AssertionError("the shared prefix was not adopted")
    decode_only = [s for s, c, d in steps if c == 0 and d == 1]
    decode_ms = 1e3 * statistics.median(decode_only)
    chunk_ms = [1e3 * (s - (decode_ms / 1e3 if d else 0.0)) / c
                for s, c, d in steps if c > 0]
    print(f"  launches: {counts} (= 32 x {st.prefill_chunks} chunks, "
          f"32 x {st.steps} decode steps)")
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
    kattn.reset_launch_counts()
    out_card = ServeEngine(cfg, card, device="cuda", **kw).generate(reqs)
    launched = kattn.launch_counts()
    out_cpu = ServeEngine(cfg, cpu, device="cpu", **kw).generate(reqs)
    tc = [o.tokens.tolist() for o in out_card]
    if tc != [o.tokens.tolist() for o in out_cpu]:
        raise AssertionError("card and CPU tokens differ")
    if 0 in launched.values():
        raise AssertionError(f"the card run did not use the kernels: {launched}")
    print(f"  first logits max abs diff {err:.3e} (tol 1e-4); tokens identical "
          f"over {sum(len(t) for t in tc)} tokens; card launches {launched}")


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
            if "Used" in line:
                print(f"    {line}")

    records = kernels_phase()
    counts = full_width_phase()
    card_vs_cpu_phase()
    for rec in records:
        rec["launches"] = counts[rec["name"]]

    print()
    print(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
