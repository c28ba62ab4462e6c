"""Quickstart of the PyTorch port: DiveBatch end to end in about a minute.

The port's counterpart of ``examples/quickstart.py``: trains the paper's
synthetic logistic-regression task with a ``repro_torch.adapt`` program,
shows the batch-size/diversity trajectory, checkpoints, kills the trainer,
and resumes, with ``repro_torch.obs`` telemetry on the whole way: one span
trace and one JSONL run log cover both trainers, and the port's monitor
(``repro_torch.launch.monitor``) prints the reconstructed schedule at the
end.  The checkpoint is in the reference's format, so the JAX package's
``Trainer.resume`` reads it too.

  PYTHONPATH=src python examples/torch_quickstart.py              # on the card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""

import argparse
import tempfile

import torch

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.adapt import AdaptationProgram, DiveBatchPolicy, LrCoupling
from repro_torch.ckpt import CheckpointManager
from repro_torch.core.controller import step_decay
from repro_torch.data import sigmoid_synthetic
from repro_torch.launch import monitor
from repro_torch.models import small
from repro_torch.obs import RunLog, Tracer
from repro_torch.optim import sgd
from repro_torch.train.loop import ModelFns, Trainer


def make_program():
    """DiveBatch: m <- min(m_max, delta * n * Delta_hat), epoch cadence,
    with the paper's background step decay on the learning rate."""
    return AdaptationProgram(
        DiveBatchPolicy(m0=64, m_max=2048, delta=1.0, dataset_size=8000, granule=16),
        base_lr=2.0,
        coupling=LrCoupling(rule="none", decay=step_decay(0.75, 20)),
        estimator="exact",
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. data + model (the paper's eq. 3 synthetic task)
    train, val, _ = sigmoid_synthetic(n=8000, d=128, seed=0)
    fns = ModelFns(
        batch_loss=small.logreg_batch_loss,
        example_loss=small.logreg_loss,  # per-sample: enables the exact tier
        metrics=lambda p, b: {"acc": small.logreg_accuracy(p, b)},
    )

    def params():
        return small.logreg_init(torch.Generator().manual_seed(0), 128, device=dev)

    # 2. telemetry: one tracer + one run log span the whole run
    run_dir = tempfile.mkdtemp(prefix="divebatch_torch_quickstart_run_")
    tracer, runlog = Tracer(), RunLog(run_dir, meta={"cmd": "quickstart"})

    # 3. train with checkpointing
    ckpt_dir = tempfile.mkdtemp(prefix="divebatch_torch_quickstart_")
    trainer = Trainer(fns, params(), sgd(momentum=0.9), make_program(), train, val,
                      estimator="exact", ckpt=CheckpointManager(ckpt_dir), ckpt_every=2,
                      tracer=tracer, runlog=runlog)
    print(f"== training 6 epochs on {dev} ==")
    trainer.run(6)

    # 4. simulate a crash: rebuild everything and resume from the checkpoint
    print("== 'crash' -> resume ==")
    trainer2 = Trainer(fns, params(), sgd(momentum=0.9), make_program(), train, val,
                       estimator="exact", ckpt=CheckpointManager(ckpt_dir),
                       tracer=tracer, runlog=runlog)
    trainer2.resume()
    trainer2.run(2)

    print("\nbatch-size trajectory:", [h.batch_size for h in trainer2.history])
    print("diversity trajectory:  ",
          [f"{h.diversity:.3f}" if h.diversity is not None else "-"
           for h in trainer2.history])
    print("final val acc:", trainer2.history[-1].val_metrics["acc"])
    stats = trainer2.engine.stats
    print(f"engine: {stats.compiles} step keys for buckets {stats.buckets}, "
          f"{stats.bucket_hits} hits, donated={stats.donate}")

    # 5. what the run log + trace captured (the monitor is the reader:
    #    python -m repro_torch.launch.monitor <run_dir> [--trace OUT])
    print("\n== telemetry (repro_torch.obs) ==")
    print("trace:", tracer.save(run_dir), f"({len(tracer.events)} events)")
    runlog.close()
    print(monitor.summary(monitor.load(run_dir)))
    return trainer2


if __name__ == "__main__":
    main()
