"""Serving CLI of the port: continuous-batching decode of a ported model.

Counterpart of ``repro/launch/serve.py``.  Runs on the card by default
(``--device cuda``; it raises without one) and on the CPU only when asked
(``--device cpu``).  ``--elastic`` wires a ``MeshLadder`` into the engine,
so the live slot bucket picks the rung: on one process over ``--dp``
(default 8) virtual devices of the device, whose rungs keep whole leaves on
it; under ``torchrun`` over the world's ranks (``--backend nccl|gloo``;
NCCL wants a card per rank, gloo lets several ranks share one card), whose
rungs shard the parameters and split the decode rows.  ``--dp N`` instead
pins a fixed N-wide data-parallel plan: N virtual devices on one process, a
world of N ranks under ``torchrun``.  ``--tp N`` (under ``torchrun``
only) serves tensor-parallel on a ``(data W/N, model N)`` rung of the W
ranks: each rank computes its heads and FFN columns, its ``d/N``
embedding columns and, where N divides the vocabulary, its ``V/N`` logits,
and its KV pool holds its KV heads (``serve/engine.py``,
``models/transformer.py``); with ``--elastic`` the ladder keeps
the model axis of N on every rung.  Only the first rank prints and writes
``--out``.

Examples:
  python -m repro_torch.launch.serve --arch yi-6b --full-size
  python -m repro_torch.launch.serve --arch gemma2-27b --full-size
  python -m repro_torch.launch.serve --arch falcon-mamba-7b --full-size --max-seq 8192
  python -m repro_torch.launch.serve --requests 16 --prefill-chunk 8 --block-size 8
  python -m repro_torch.launch.serve --device cpu --policy fair --tenants 2
  python -m repro_torch.launch.serve --device cpu --elastic --requests 8 --ramp 2
  torchrun --nproc-per-node 2 -m repro_torch.launch.serve --device cpu --elastic \\
      --backend gloo --requests 8 --ramp 2
  torchrun --nproc-per-node 2 -m repro_torch.launch.serve --device cpu --tp 2 \\
      --backend gloo --requests 8
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.dist.plan import process_rank, use_plan
from repro_torch.elastic import MeshLadder
from repro_torch.elastic.ladder import DEFAULT_VIRTUAL_DEVICES
from repro_torch.kernels import _build
from repro_torch.launch.mesh import rank_setup
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


def init_model(cfg, seed: int, device: torch.device) -> tf.Transformer:
    """The served model: random weights from ``seed`` (every rank draws
    the same ones)."""
    return tf.init_params(cfg, torch.Generator(device=device).manual_seed(seed), device)


def main(argv=None) -> dict:
    """Run the CLI; returns ``{"engine", "results"}``."""
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
    ap.add_argument("--dp", type=int, default=0,
                    help="pin a fixed dp-wide plan (the non-elastic baseline): "
                         "virtual devices, or a world of N ranks under torchrun")
    ap.add_argument("--elastic", action="store_true",
                    help="MeshLadder over --dp (default: all) devices; the live slot "
                         "count picks the rung")
    ap.add_argument("--tp", type=int, default=0,
                    help="tensor-parallel ranks under torchrun: a (data W/N, model N) "
                         "rung of the W ranks (the ladder's model axis with --elastic)")
    ap.add_argument("--backend", default="nccl", choices=["nccl", "gloo"],
                    help="the process group's backend under torchrun")
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

    plan = ladder = None
    ranked = dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) > 1
    if args.tp or (ranked and (args.dp or args.elastic)):
        device, plan, ladder = rank_setup(args.backend, dp=args.dp, device=args.device,
                                          elastic=args.elastic, granule=1,
                                          command="repro_torch.launch.serve", tp=args.tp)
    else:
        device = resolve_device(args.device)
        if args.elastic:
            ladder = MeshLadder([device] * (args.dp or DEFAULT_VIRTUAL_DEVICES), granule=1)
        elif args.dp:  # a fixed plan: the widest rung of a ladder over dp virtual devices
            plan = MeshLadder([device] * args.dp).full.plan
    first = process_rank() == 0
    cfg = get_config(args.arch, reduced=not args.full_size)
    if not args.full_size:
        # at most 4 layers, but a whole period of the pattern (jamba's is 8)
        cfg = cfg.replace(num_layers=min(cfg.num_layers, max(4, cfg.period)), d_model=128,
                          num_heads=4, num_kv_heads=2)
    params = init_model(cfg, args.seed, device)

    tracer, runlog = obs_from_cli(
        args.trace if first else None, args.runlog if first else None,
        meta={"cmd": "serve", "arch": args.arch, "requests": args.requests,
              "seed": args.seed, "elastic": bool(args.elastic), "policy": args.policy,
              "device": str(device)},
    )
    with use_plan(plan) if plan is not None else contextlib.nullcontext():
        engine = ServeEngine(
            cfg, params, device=device, max_slots=args.max_slots,
            max_seq=args.max_seq, sampler=args.sampler,
            temperature=args.temperature, seed=args.seed,
            prompt_granule=args.prompt_granule, elastic=ladder,
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
    if args.profile and first:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        prof_ctx = profile(activities=acts)
    t0 = time.perf_counter()
    with prof_ctx as prof:
        results = serve_trace(engine, requests, args.ramp)
        if on_card:
            torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not first:
        return {"engine": engine, "results": results}
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
    print(f"engine: programs={stats.compiles} (buckets={stats.buckets} "
          f"rungs={stats.rungs}) prefill={stats.prefill_compiles} "
          f"aux={stats.aux_compiles} hits={stats.bucket_hits}")
    print(f"pool: {stats.peak_blocks}/{stats.pool_blocks} blocks peak "
          f"(block={stats.block_size}) chunks={stats.prefill_chunks} "
          f"shared_hits={stats.shared_prefill_hits} "
          f"shared_blocks={stats.shared_blocks} cow={stats.cow_copies}")
    if ladder is not None:
        print(f"elastic: ladder dp={ladder.widths} reshards={stats.reshards} "
              f"resizes={stats.resizes}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(
                {"results": [{"steps": r.steps, "tokens": r.tokens.tolist()}
                             for r in results],
                 "stats": stats.as_dict()},
                f, indent=1,
            )
    return {"engine": engine, "results": results}


if __name__ == "__main__":
    main()
