"""Paper §5.1 on the PyTorch port: synthetic convex + nonconvex experiments.

The port's counterpart of ``examples/synthetic_convex.py``: SGD / DiveBatch
/ Oracle on the eq. 3 dataset with the paper's protocol (small-batch
baseline lr, delta values, step decay); writes a JSON and prints a table
mirroring Figures 1-2.

  PYTHONPATH=src python examples/torch_synthetic_convex.py [--full]
  PYTHONPATH=src python examples/torch_synthetic_convex.py --device cpu
"""

import argparse
import dataclasses
import json
import os

import torch

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.core.batch_policy import make_policy
from repro_torch.core.controller import AdaptiveBatchController, step_decay
from repro_torch.data import sigmoid_synthetic
from repro_torch.models import small
from repro_torch.optim import sgd
from repro_torch.train.loop import ModelFns, Trainer


def run_method(task, method, estimator, *, n, d, epochs, delta, m0, m_max, lr, seed,
               device):
    train, val, _ = sigmoid_synthetic(n=n, d=d, seed=seed)
    gen = torch.Generator().manual_seed(seed)
    if task == "convex":
        params = small.logreg_init(gen, d, device=device)
        fns = ModelFns(small.logreg_batch_loss, small.logreg_loss,
                       lambda p, b: {"acc": small.logreg_accuracy(p, b)})
    else:
        params = small.mlp_init(gen, d, device=device)
        fns = ModelFns(small.mlp_batch_loss, small.mlp_loss,
                       lambda p, b: {"acc": small.mlp_accuracy(p, b)})
    ctrl = AdaptiveBatchController(
        make_policy(method if method != "oracle" else "divebatch",
                    m0=m0, m_max=m_max, delta=delta, dataset_size=len(train), granule=16),
        base_lr=lr, lr_schedule=step_decay(0.75, 20),
    )
    t = Trainer(fns, params, sgd(momentum=0.9), ctrl, train, val, estimator=estimator,
                seed=seed)
    return t.run(epochs, verbose=False)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    ap.add_argument("--full", action="store_true",
                    help="paper scale: n=20000, d=512, 100 epochs")
    ap.add_argument("--epochs", type=int, default=None,
                    help="override the epochs (15, or 100 with --full)")
    ap.add_argument("--out", default="runs/torch_synthetic_convex.json")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    scale = dict(n=20_000, d=512, epochs=100) if args.full else dict(n=4000, d=128, epochs=15)
    if args.epochs:
        scale["epochs"] = args.epochs
    results = {}
    for task, delta, lr in [("convex", 1.0, 2.0), ("nonconvex", 0.1, 0.5)]:
        for method, est in [("sgd", "none"), ("divebatch", "exact"), ("oracle", "oracle")]:
            hist = run_method(task, method, est, delta=delta, m0=64,
                              m_max=1024 if not args.full else 4096, lr=lr, seed=0,
                              device=dev, **scale)
            key = f"{task}/{method}"
            results[key] = [dataclasses.asdict(h) for h in hist]
            accs = [h.val_metrics["acc"] for h in hist]
            print(f"{key:24s} final_acc={accs[-1]:.4f} end_batch={hist[-1].batch_size:5d} "
                  f"acc_curve={[round(a, 3) for a in accs[:: max(len(accs) // 6, 1)]]}")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print("wrote", args.out)
    return results


if __name__ == "__main__":
    main()
