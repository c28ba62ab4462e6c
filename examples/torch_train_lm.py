"""End-to-end LM training with the PyTorch port: the production train step
(microbatch accumulation + the in-step moment estimator) on a transformer
LM, adapted at step granularity.

The port's counterpart of ``examples/train_lm.py``.  A tick-fired
``repro_torch.adapt`` program (DiveBatch over the accumulation window, or
``--method gns`` for the gradient-noise-scale family) observes the
accumulators every ``--epoch-steps`` optimizer steps through
``read_signals`` (one stacked device -> host read) and resizes the global
batch onto the ``num_micro`` bucket lattice.  ``--ckpt-dir`` saves the
state and the program at every tick in the reference's checkpoint format.

The default model is the ~20M-parameter ``lm-20m``; ``--model-100m`` the
~100M one (the same code path).  Runs on the card unless ``--device cpu``.

  PYTHONPATH=src python examples/torch_train_lm.py --steps 30
  PYTHONPATH=src python examples/torch_train_lm.py --method gns --steps 30
  PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 6 --seq-len 16
"""

import argparse
import time

import torch

from repro_torch import DEFAULT_DEVICE, interop, resolve_device
from repro_torch.adapt import (
    AdaptationProgram,
    Clock,
    DiveBatchPolicy,
    GradNoisePolicy,
    read_signals,
)
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.data import TokenStream
from repro_torch.models import transformer as tf
from repro_torch.optim import sgd
from repro_torch.train import StepEngine, init_state


def model_config(big: bool) -> ModelConfig:
    if big:  # ~100M params
        return ModelConfig(
            name="lm-100m", family="dense", num_layers=12, d_model=768,
            num_heads=12, num_kv_heads=4, d_ff=2048, vocab_size=32_000,
            param_dtype="float32", compute_dtype="float32", xent_chunk=128,
            remat=False,
        )
    return ModelConfig(  # ~20M params
        name="lm-20m", family="dense", num_layers=6, d_model=384,
        num_heads=6, num_kv_heads=2, d_ff=1024, vocab_size=8_000,
        param_dtype="float32", compute_dtype="float32", xent_chunk=128,
        remat=False,
    )


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--method", default="divebatch", choices=["divebatch", "gns"])
    ap.add_argument("--model-100m", action="store_true")
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--micro-batch", type=int, default=4)
    ap.add_argument("--m0", type=int, default=8, help="initial global batch (sequences)")
    ap.add_argument("--m-max", type=int, default=64)
    ap.add_argument("--delta", type=float, default=0.5,
                    help="DiveBatch scale: m = delta * n_window * Delta_hat")
    ap.add_argument("--epoch-steps", type=int, default=10,
                    help="steps per tick (diversity/batch-size update period)")
    ap.add_argument("--lr", type=float, default=0.3)
    ap.add_argument("--ckpt-dir", default=None)
    return ap


def make_program(args) -> AdaptationProgram:
    """DiveBatch scaled by the accumulation window (``dataset_size=None``:
    the samples seen since the last reset), or the gradient-noise family."""
    if args.method == "gns":
        policy = GradNoisePolicy(args.m0, args.m_max, granule=args.micro_batch,
                                 alpha=1.0, on_tick=True)
    else:
        policy = DiveBatchPolicy(args.m0, args.m_max, delta=args.delta,
                                 dataset_size=None, granule=args.micro_batch, on_tick=True)
    return AdaptationProgram(policy, base_lr=args.lr, estimator="moment",
                             tick_every=args.epoch_steps)


def run(cfg: ModelConfig, params: tf.Transformer, args, log=print) -> dict:
    """Train ``params`` (on their device) for ``args.steps`` steps; returns
    ``{"batch": [...], "loss": [...], "engine": StepEngine}`` per step."""
    dev = next(params.parameters()).device
    opt = sgd(momentum=0.9)
    state = init_state(params, opt)
    stream = TokenStream(cfg.vocab_size, seed=0)
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    # one step per num_micro bucket, the same StepEngine the Trainer drives
    engine = StepEngine.for_lm(cfg, opt, micro_batch=args.micro_batch)
    program = make_program(args)
    out = {"batch": [], "loss": []}
    m = program.batch_size
    for step in range(args.steps):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in stream.batch(step, m, args.seq_len).items()}
        t0 = time.time()
        state, metrics = engine.step(state, batch, program.lr)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        out["batch"].append(m)
        out["loss"].append(loss)
        if (step + 1) % program.tick_every == 0:
            # one stacked read: diversity + GNS + window samples; the reset
            # starts the next accumulation window
            sig, state = read_signals(state, "moment", reset=True, batch_size=m, loss=loss)
            program.observe(sig, Clock(epoch=step // program.tick_every, step=step + 1,
                                       boundary="tick"))
            log(f"step {step+1:4d} loss={loss:.4f} dt={dt:.2f}s  Delta={sig.diversity:.4f} "
                f"gns={sig.gns:.1f} -> batch {m} -> {program.batch_size}")
            m = program.batch_size
            if mgr:
                mgr.save(step + 1, {"state": interop.reference_state(state)},
                         extra={"program": program.state_dict()})
        elif step % 5 == 0:
            log(f"step {step+1:4d} loss={loss:.4f} dt={dt:.2f}s batch={m}")
    stats = engine.stats
    log(f"done. compiled buckets: {sorted(stats.buckets)} (num_micro values), "
        f"{stats.compiles} compiles / {stats.steps} steps, donated={stats.donate}")
    out["engine"] = engine
    return out


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    dev = resolve_device(args.device)
    cfg = model_config(args.model_100m)
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"model: {cfg.name}, {n_params/1e6:.1f}M params on {dev}")
    return run(cfg, params, args)


if __name__ == "__main__":
    main()
