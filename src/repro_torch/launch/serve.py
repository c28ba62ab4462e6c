"""Serving CLI of the port: continuous-batching decode of a ported model.

Counterpart of ``repro/launch/serve.py`` on one device.  Runs on the card by
default (``--device cuda``; it raises without one) and on the CPU only when
asked (``--device cpu``).  The elastic ladder and fixed dp plans are not
ported.

Examples:
  python -m repro_torch.launch.serve --arch yi-6b --full-size
  python -m repro_torch.launch.serve --arch gemma2-27b --full-size
  python -m repro_torch.launch.serve --arch falcon-mamba-7b --full-size --max-seq 8192
  python -m repro_torch.launch.serve --requests 16 --prefill-chunk 8 --block-size 8
  python -m repro_torch.launch.serve --device cpu --policy fair --tenants 2
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.kernels import _build
from repro_torch.models import transformer as tf
from repro_torch.obs import from_cli as obs_from_cli
from repro_torch.serve import POLICIES, Request, ServeEngine


def build_requests(cfg, n: int, *, max_new: int, seed: int,
                   tenants: int = 0) -> list[Request]:
    """Synthetic request set (the reference CLI's, draw for draw); with
    ``tenants > 0`` request *i* belongs to tenant ``t<i % tenants>`` with
    priority ``i % tenants``."""
    rng = np.random.default_rng(seed)
    return [
        Request(
            prompt=rng.integers(
                1, cfg.vocab_size, size=int(rng.integers(4, 24))
            ).astype(np.int32),
            max_new_tokens=int(rng.integers(max(max_new // 2, 1), max_new + 1)),
            tenant=f"t{i % tenants}" if tenants else None,
            priority=i % tenants if tenants else 0,
        )
        for i in range(n)
    ]


def serve_trace(engine: ServeEngine, requests: list[Request], ramp: int) -> list:
    """Drive an arrival trace: one request every ``ramp`` engine steps
    (``ramp=0`` submits everything up front), then drain."""
    rids = []
    if ramp <= 0:
        rids = [engine.submit(r) for r in requests]
        engine.drain()
    else:
        pending = list(requests)
        while pending or engine.busy:
            if pending:
                rids.append(engine.submit(pending.pop(0)))
                for _ in range(ramp):
                    if not engine.step():
                        break
            else:
                engine.step()
    return [engine.result(rid) for rid in rids]


def main(argv=None):
    ap = argparse.ArgumentParser()
    # the engine serves causal decoders with token prompts
    served = [a for a in ARCH_NAMES
              if get_config(a).input_mode == "tokens" and get_config(a).causal]
    ap.add_argument("--arch", default="yi-6b", choices=served,
                    help="configs registry arch (served reduced + shrunk "
                         "unless --full-size)")
    ap.add_argument("--full-size", action="store_true")
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    help="'cuda' (default; needs a Hopper card) or 'cpu'")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--ramp", type=int, default=0,
                    help="submit one request every N engine steps (0 = all "
                         "up front)")
    ap.add_argument("--max-slots", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--prompt-granule", type=int, default=8)
    ap.add_argument("--block-size", type=int, default=0,
                    help="KV pool block size in tokens (0 = prompt granule)")
    ap.add_argument("--pool-blocks", type=int, default=0,
                    help="KV pool capacity in blocks (0 = worst-case for "
                         "max_slots, pow2)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="prefill chunk length in tokens (0 = whole prompt "
                         "per boundary); chunks interleave with decode")
    ap.add_argument("--no-prefix-sharing", action="store_true",
                    help="disable chain-hash prompt prefix sharing")
    ap.add_argument("--policy", default="fifo", choices=list(POLICIES),
                    help="serve-side admission policy (serve/policy.py)")
    ap.add_argument("--tenants", type=int, default=0,
                    help="stamp round-robin tenant/priority metadata onto the "
                         "synthetic requests")
    ap.add_argument("--sampler", default="greedy", choices=["greedy", "categorical"])
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="write {results, stats} JSON")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="record a Chrome/Perfetto trace and write "
                         "DIR/trace.json at exit")
    ap.add_argument("--runlog", default=None, nargs="?", const="",
                    metavar="PATH",
                    help="write the schema-versioned JSONL run log; bare "
                         "--runlog means <--trace DIR>/runlog.jsonl")
    ap.add_argument("--profile", default=None, metavar="PATH",
                    help="profile the run with torch.profiler: write a Chrome "
                         "trace to PATH and print the ops by device time")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch, reduced=not args.full_size)
    if not args.full_size:
        # at most 4 layers, but a whole period of the pattern (jamba's is 8)
        cfg = cfg.replace(num_layers=min(cfg.num_layers, max(4, cfg.period)), d_model=128,
                          num_heads=4, num_kv_heads=2)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = tf.init_params(cfg, gen, device)

    tracer, runlog = obs_from_cli(
        args.trace, args.runlog,
        meta={"cmd": "serve", "arch": args.arch, "requests": args.requests,
              "seed": args.seed, "elastic": False, "policy": args.policy,
              "device": str(device)},
    )
    engine = ServeEngine(
        cfg, params, device=device, max_slots=args.max_slots,
        max_seq=args.max_seq, sampler=args.sampler,
        temperature=args.temperature, seed=args.seed,
        prompt_granule=args.prompt_granule,
        block_size=args.block_size or None,
        pool_blocks=args.pool_blocks or None,
        prefill_chunk=args.prefill_chunk,
        prefix_sharing=not args.no_prefix_sharing,
        policy=args.policy, tracer=tracer, runlog=runlog,
    )
    requests = build_requests(cfg, args.requests, max_new=args.max_new,
                              seed=args.seed, tenants=args.tenants)
    on_card = device.type == "cuda"
    if on_card:
        _build.build_all()  # nvcc before the first request, not inside it
    prof_ctx = contextlib.nullcontext()
    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        prof_ctx = profile(activities=acts)
    t0 = time.perf_counter()
    with prof_ctx as prof:
        results = serve_trace(engine, requests, args.ramp)
        if on_card:
            torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if args.profile:
        prof.export_chrome_trace(args.profile)
        key = "self_device_time_total" if on_card else "self_cpu_time_total"
        print(prof.key_averages().table(sort_by=key, row_limit=15))
        if on_card:
            # device kernels only: an op's self device time repeats its kernels'
            busy = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
            print(f"profile: device busy {busy:.4f} s of {wall:.4f} s wall "
                  f"(idle share {1 - busy / wall:.3f}, profiler on)")
    if tracer is not None:
        print(f"trace: {tracer.save(args.trace)}")
    if runlog is not None:
        runlog.close()
        print(f"runlog: {runlog.path}")

    stats = engine.stats
    total = sum(r.steps for r in results)
    print(f"device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    print(f"policy: {args.policy}"
          + (f" ({args.tenants} tenants)" if args.tenants else ""))
    print(f"served {len(results)} requests, {total} tokens "
          f"({stats.tokens_per_sec:.1f} tok/s windowed, "
          f"{stats.steps} decode steps, {stats.slot_steps} decoded lanes)")
    print(f"engine: programs={stats.compiles} (buckets={stats.buckets}) "
          f"prefill={stats.prefill_compiles} aux={stats.aux_compiles} "
          f"hits={stats.bucket_hits}")
    print(f"pool: {stats.peak_blocks}/{stats.pool_blocks} blocks peak "
          f"(block={stats.block_size}) chunks={stats.prefill_chunks} "
          f"shared_hits={stats.shared_prefill_hits} "
          f"shared_blocks={stats.shared_blocks} cow={stats.cow_copies}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(
                {"results": [{"steps": r.steps, "tokens": r.tokens.tolist()}
                             for r in results],
                 "stats": stats.as_dict()},
                f, indent=1,
            )


if __name__ == "__main__":
    main()
