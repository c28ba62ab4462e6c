"""Which collectives gloo runs on CUDA tensors, and how long they take.

  python3 tools/gloo_collectives.py

Spawns 2 gloo ranks on card 0 (they meet through a ``FileStore`` under
``build/``), tries each collective the sharded state uses, and its list form,
on CUDA tensors (float32, bf16, int64), then times a bf16 all-gather,
reduce-scatter, all-to-all and all-reduce of 256 MiB buffers (mean of 3
after a warm-up).  Prints one line per rank and case.  Needs a card.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

N = 64 << 20  # elements of a timed buffer's half: 2 N bf16 = 256 MiB


def _cases(dev, rank):
    x = torch.arange(8, dtype=torch.float32, device=dev) + 100 * rank

    def gather(dt=torch.float32):
        out = torch.empty(16, device=dev, dtype=dt)
        dist.all_gather_into_tensor(out, x.to(dt))
        assert out[8:].float().eq(torch.arange(8, device=dev) + 100).all()

    def scatter(dt=torch.float32):
        out = torch.empty(8, device=dev, dtype=dt)
        dist.reduce_scatter_tensor(out, torch.full((16,), rank + 1.0, device=dev, dtype=dt))
        assert out.float().eq(3).all()

    def alltoall(dt=torch.float32):
        out = torch.empty(8, device=dev, dtype=dt)
        dist.all_to_all_single(out, x.to(dt))
        # half k comes from rank k: its k-th half
        want = torch.cat([torch.arange(4 * rank, 4 * rank + 4, device=dev) + 100 * k
                          for k in range(2)])
        assert out.float().eq(want).all()

    return [
        ("all_gather_into_tensor float32", gather),
        ("all_gather_into_tensor bf16", lambda: gather(torch.bfloat16)),
        ("all_gather (list)", lambda: dist.all_gather(
            [torch.empty(8, device=dev) for _ in range(2)], x)),
        ("reduce_scatter_tensor float32", scatter),
        ("reduce_scatter_tensor bf16", lambda: scatter(torch.bfloat16)),
        ("reduce_scatter (list)", lambda: dist.reduce_scatter(
            torch.empty(8, device=dev), [torch.ones(8, device=dev)] * 2)),
        ("all_to_all_single float32", alltoall),
        ("all_to_all_single bf16", lambda: alltoall(torch.bfloat16)),
        ("all_to_all_single int64", lambda: alltoall(torch.int64)),
        ("all_to_all (list)", lambda: dist.all_to_all(
            [torch.empty(4, device=dev) for _ in range(2)], list(x.split(4)))),
        ("all_reduce", lambda: dist.all_reduce(x.clone())),
    ]


def _timed(dev):
    bf = torch.bfloat16
    return [
        ("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
            torch.empty(2 * N, device=dev, dtype=bf), torch.ones(N, device=dev, dtype=bf))),
        ("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(
            torch.empty(N, device=dev, dtype=bf), torch.ones(2 * N, device=dev, dtype=bf))),
        ("all_to_all_single", lambda: dist.all_to_all_single(
            torch.empty(2 * N, device=dev, dtype=bf), torch.ones(2 * N, device=dev, dtype=bf))),
        ("all_reduce", lambda: dist.all_reduce(torch.ones(2 * N, device=dev, dtype=bf))),
    ]


def run(rank: int, world: int, store: str, queue) -> None:
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    lines = []
    for name, fn in _cases(dev, rank):
        try:
            fn()
            torch.cuda.synchronize()
            lines.append(f"{name}: ok")
        except Exception as e:  # the backend's refusal is the finding
            lines.append(f"{name}: refused ({str(e)[:120]})")
        dist.barrier()
    for name, fn in _timed(dev):
        fn()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        lines.append(f"{name} of 256 MiB (bf16): {(time.perf_counter() - t0) / 3:.4f} s")
    queue.put((rank, lines))
    dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    build = Path(__file__).resolve().parent.parent / "build"
    build.mkdir(exist_ok=True)
    store = build / f"store_gloo_collectives_{os.getpid()}"
    store.unlink(missing_ok=True)
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=run, args=(r, 2, str(store), queue)) for r in range(2)]
    for p in procs:
        p.start()
    try:
        out = dict(queue.get(timeout=300) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
        store.unlink(missing_ok=True)
    for r in sorted(out):
        for line in out[r]:
            print(f"rank {r}: {line}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
