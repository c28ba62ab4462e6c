"""DiveBatch LM training: the production train step (microbatch accumulation
with the in-step moment tier) on a transformer LM, adapted at step
granularity.

Counterpart of ``examples/train_lm.py``.  A tick-fired policy (DiveBatch
over the accumulation window, or ``--method gns`` for the gradient-noise
family) observes the diversity accumulators every ``--epoch-steps``
optimizer steps through ``read_signals`` (one stacked device -> host read)
and resizes the global batch onto the ``num_micro`` bucket lattice.
Attention runs on the kernel lane (``--attn-impl pallas``, the default).

  python -m repro_torch.launch.train_lm --steps 30             # on the card
  python -m repro_torch.launch.train_lm --device cpu --steps 6 --seq-len 32
  python -m repro_torch.launch.train_lm --full-width 8 --seq-len 2048 \\
      --micro-batch 2 --m0 4 --m-max 16 --epoch-steps 4 --steps 12

The default model is the ~20M-parameter ``lm-20m`` (float32);
``--full-width N`` trains Yi-6B's widths (d_model 4096, 32/4 heads, d_ff
11008, vocab 64000) at N of its 32 layers, bf16 with per-layer remat.
Weights are random, from ``--seed``.  The device defaults to ``cuda`` and
raises without a Hopper card.  Checkpointing (``--ckpt-dir``) comes with the
port of ``ckpt/`` (ROADMAP.md, Queue A).
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.adapt import (
    AdaptationProgram,
    Clock,
    DiveBatchPolicy,
    GradNoisePolicy,
    read_signals,
)
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data import TokenStream
from repro_torch.models import transformer as tf
from repro_torch.optim import sgd
from repro_torch.train import StepEngine, init_state
from repro_torch.utils import pytree as ptu


def model_config(full_width: int | None = None) -> ModelConfig:
    """``lm-20m`` (the reference example's default), or Yi-6B's widths at
    ``full_width`` layers."""
    if full_width:
        return get_config("yi-6b").replace(num_layers=int(full_width))
    return ModelConfig(
        name="lm-20m", family="dense", num_layers=6, d_model=384,
        num_heads=6, num_kv_heads=2, d_ff=1024, vocab_size=8_000,
        param_dtype="float32", compute_dtype="float32", xent_chunk=128,
        remat=False,
    )


def make_program(method: str, *, m0: int, m_max: int, delta: float, granule: int,
                 lr: float, tick_every: int) -> AdaptationProgram:
    """A tick-fired program over the step stream: DiveBatch scaled by the
    accumulation window (``dataset_size=None``), or the gradient-noise
    family."""
    if method == "gns":
        policy = GradNoisePolicy(m0, m_max, granule=granule, alpha=1.0, on_tick=True)
    elif method == "divebatch":
        policy = DiveBatchPolicy(m0, m_max, delta=delta, dataset_size=None,
                                 granule=granule, on_tick=True)
    else:
        raise ValueError(f"unknown method {method!r}")
    return AdaptationProgram(policy, base_lr=lr, estimator="moment", tick_every=tick_every)


def train(cfg: ModelConfig, params: tf.Transformer, program: AdaptationProgram, *,
          steps: int, seq_len: int, micro_batch: int, attn_impl: str = "pallas",
          data_seed: int = 0, log=print, engine: StepEngine | None = None,
          estimator: str = "moment") -> dict:
    """Train ``params`` in place for ``steps`` optimizer steps.

    Each step's loss is read back (so a step's wall time covers its device
    work); at every tick the signals are read with ``estimator``, the
    accumulators reset and the program decides the next batch.  ``engine``
    defaults to ``StepEngine.for_lm`` (the moment tier); a prebuilt one (the
    gram tier's, say) must have been built with ``sgd(momentum=0.9)`` and
    ``micro_batch``.  Returns ``{"records": [per-step dicts], "engine":
    StepEngine, "state": TrainState}``; a record holds ``step, batch,
    num_micro, loss, seconds`` and, at ticks, ``diversity, gns,
    next_batch``."""
    dev = next(params.parameters()).device
    opt = sgd(momentum=0.9)
    state = init_state(params, opt)
    stream = TokenStream(cfg.vocab_size, seed=data_seed)
    if engine is None:
        engine = StepEngine.for_lm(cfg, opt, micro_batch=micro_batch, attn_impl=attn_impl)
    m = program.batch_size
    records = []
    for step in range(steps):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in stream.batch(step, m, seq_len).items()}
        t0 = time.perf_counter()
        state, metrics = engine.step(state, batch, program.lr)
        loss = float(metrics["loss"])
        rec = {"step": step + 1, "batch": m, "num_micro": m // micro_batch, "loss": loss,
               "seconds": time.perf_counter() - t0}
        if (step + 1) % program.tick_every == 0:
            sig, state = read_signals(state, estimator, reset=True, batch_size=m, loss=loss)
            program.observe(sig, Clock(epoch=step // program.tick_every, step=step + 1,
                                       boundary="tick"))
            rec.update(diversity=sig.diversity, gns=sig.gns, next_batch=program.batch_size)
            log(f"step {step + 1:4d} loss={loss:.4f} dt={rec['seconds']:.2f}s "
                f"Delta={sig.diversity:.4f} gns={sig.gns:.1f} -> batch {m} -> "
                f"{program.batch_size}")
            m = program.batch_size
        elif step % 5 == 0:
            log(f"step {step + 1:4d} loss={loss:.4f} dt={rec['seconds']:.2f}s batch={m}")
        records.append(rec)
    stats = engine.stats
    log(f"done. buckets: {sorted(set(stats.buckets))} (num_micro values), "
        f"{stats.compiles} step keys / {stats.steps} steps")
    return {"records": records, "engine": engine, "state": state}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--method", default="divebatch", choices=["divebatch", "gns"])
    ap.add_argument("--full-width", type=int, default=None, metavar="N",
                    help="Yi-6B widths at N layers (bf16, remat)")
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--micro-batch", type=int, default=4)
    ap.add_argument("--m0", type=int, default=8, help="initial global batch (sequences)")
    ap.add_argument("--m-max", type=int, default=64)
    ap.add_argument("--delta", type=float, default=0.5,
                    help="DiveBatch scale: m = delta * n_window * Delta_hat")
    ap.add_argument("--epoch-steps", type=int, default=10,
                    help="steps per tick (diversity/batch-size update period)")
    ap.add_argument("--lr", type=float, default=0.3)
    ap.add_argument("--attn-impl", default="pallas", choices=["pallas", "dense"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)
    if args.ckpt_dir is not None:
        raise NotImplementedError("--ckpt-dir needs ckpt/, not ported to repro_torch "
                                  "yet (ROADMAP.md, Queue A)")
    dev = resolve_device(args.device)
    cfg = model_config(args.full_width)
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    n_params = ptu.tree_count(params)
    print(f"model: {cfg.name} x {cfg.num_layers} layers, {n_params / 1e6:.1f}M params "
          f"on {dev}")
    program = make_program(args.method, m0=args.m0, m_max=args.m_max, delta=args.delta,
                           granule=args.micro_batch, lr=args.lr,
                           tick_every=args.epoch_steps)
    return train(cfg, params, program, steps=args.steps, seq_len=args.seq_len,
                 micro_batch=args.micro_batch, attn_impl=args.attn_impl)


if __name__ == "__main__":
    main()
