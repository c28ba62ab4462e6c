"""Serving example of the PyTorch port: elastic continuous batching through
the ServeEngine.

The port's counterpart of ``examples/serve_lm.py``.  Requests stream in,
the Scheduler admits them into pow2 slot buckets, retires each one at its
own EOS/max-token step, and a ``MeshLadder`` over eight virtual devices of
the device (the port's default device list) follows the live batch up and
down its rungs; a local rung keeps whole leaves, so a rung change moves no
byte.  Runs on the card unless ``--device cpu``.

``--policy`` swaps the admission policy (serve/policy.py): ``fifo`` is the
default engine behaviour, ``priority``/``fair`` read the tenant/priority
metadata this example stamps onto every other request.

  PYTHONPATH=src python examples/torch_serve_lm.py
  PYTHONPATH=src python examples/torch_serve_lm.py --device cpu --policy fair
"""

import argparse
import time

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.configs import get_config
from repro_torch.elastic import MeshLadder
from repro_torch.elastic.ladder import DEFAULT_VIRTUAL_DEVICES
from repro_torch.models import transformer as tf
from repro_torch.serve import POLICIES, Request, ServeEngine


def model_config():
    return get_config("yi-6b", reduced=True).replace(num_layers=4, d_model=128,
                                                    num_heads=4, num_kv_heads=2)


def requests(vocab: int) -> list[Request]:
    rng = np.random.default_rng(0)
    return [
        Request(prompt=rng.integers(1, vocab, size=rng.integers(4, 24)).astype(np.int32),
                max_new_tokens=16, tenant=f"t{i % 2}", priority=i % 2)
        for i in range(10)
    ]


def serve(cfg, params: tf.Transformer, ladder: MeshLadder, policy: str = "fifo"):
    """Serve the example's requests on ``ladder``; returns ``(results,
    engine)``."""
    engine = ServeEngine(cfg, params, max_slots=4, max_seq=256, elastic=ladder,
                         policy=policy)
    return engine.generate(requests(cfg.vocab_size)), engine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    ap.add_argument("--policy", default="fifo", choices=list(POLICIES))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = model_config()
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    ladder = MeshLadder([dev] * DEFAULT_VIRTUAL_DEVICES, granule=1)
    t0 = time.time()
    results, engine = serve(cfg, params, ladder, args.policy)
    dt = time.time() - t0
    total_tokens = sum(r.steps for r in results)
    for i, r in enumerate(results[:4]):
        print(f"req {i}: {r.steps} tokens -> {r.tokens.tolist()}")
    stats = engine.stats
    print(f"\n{len(results)} requests, {total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens/dt:.1f} tok/s end-to-end, "
          f"{stats.tokens_per_sec:.1f} tok/s windowed) on {dev}")
    print(f"slots: {stats.prefills} admissions over buckets {stats.buckets}, "
          f"{stats.slot_steps} decoded lanes for "
          f"{total_tokens - stats.prefills} decode tokens "
          f"(policy={args.policy})")
    print(f"elastic: dp={ladder.widths} reshards={stats.reshards}")
    return results, engine


if __name__ == "__main__":
    main()
