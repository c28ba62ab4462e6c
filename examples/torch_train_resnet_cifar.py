"""Paper §5.2 on the PyTorch port: ResNet(GN) image classification with
SGD / AdaBatch / DiveBatch on CIFAR-shaped data.

The port's counterpart of ``examples/train_resnet_cifar.py``.  By default
it trains on the procedural CIFAR-shaped dataset; ``--cifar-npz PATH``
trains on a CIFAR-10 export with the same code ({"x": (N, 32, 32, 3)
float32, "y": (N,) int} arrays).  Convolutions run on cuDNN; DiveBatch
takes the exact tier (per-sample gradients by ``torch.func.vmap``).

  PYTHONPATH=src python examples/torch_train_resnet_cifar.py --epochs 8
  PYTHONPATH=src python examples/torch_train_resnet_cifar.py --device cpu --epochs 1
"""

import argparse
import json
import os

import numpy as np
import torch

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.core.batch_policy import make_policy
from repro_torch.core.controller import AdaptiveBatchController
from repro_torch.data import ArrayDataset, imagelike_classification
from repro_torch.models import resnet
from repro_torch.optim import sgd
from repro_torch.train.loop import ModelFns, Trainer


def load_data(args):
    if args.cifar_npz:
        z = np.load(args.cifar_npz)
        x, y = z["x"].astype(np.float32), z["y"].astype(np.int32)
        split = int(len(x) * 0.9)
        return (ArrayDataset({"x": x[:split], "y": y[:split]}),
                ArrayDataset({"x": x[split:], "y": y[split:]}), 10)
    train, val = imagelike_classification(
        n=args.n, hw=args.hw, num_classes=args.classes, noise=0.8, template_rank=3, seed=0)
    return train, val, args.classes


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--methods", default="sgd,adabatch,divebatch")
    ap.add_argument("--depth", type=int, default=8, help="resnet depth (6n+2); paper uses 20")
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--hw", type=int, default=16)
    ap.add_argument("--classes", type=int, default=10)
    ap.add_argument("--m0", type=int, default=64)
    ap.add_argument("--m-max", type=int, default=512)
    ap.add_argument("--delta", type=float, default=0.5)
    ap.add_argument("--cifar-npz", default=None)
    ap.add_argument("--out", default="runs/torch_resnet_compare.json")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    train, val, classes = load_data(args)
    out = {}
    for method in args.methods.split(","):
        params = resnet.resnet_init(torch.Generator().manual_seed(0), depth=args.depth,
                                    width=8, num_classes=classes, device=dev)
        fns = ModelFns(resnet.resnet_batch_loss, resnet.resnet_loss,
                       lambda p, b: {"acc": resnet.resnet_accuracy(p, b)})
        m0 = args.m_max if method == "sgd_large" else args.m0
        ctrl = AdaptiveBatchController(
            make_policy(method if method != "sgd_large" else "sgd",
                        m0=m0, m_max=args.m_max, delta=args.delta,
                        dataset_size=len(train), granule=16, resize_freq=3),
            base_lr=0.1,
        )
        t = Trainer(fns, params, sgd(momentum=0.9, weight_decay=5e-4), ctrl, train, val,
                    estimator="exact" if method == "divebatch" else "none",
                    psn_microbatch=64)
        hist = t.run(args.epochs)
        out[method] = [
            {"epoch": h.epoch, "acc": h.val_metrics["acc"], "loss": h.val_loss,
             "batch": h.batch_size, "wall_s": h.wall_s} for h in hist
        ]
        print(f"== {method}: final acc {hist[-1].val_metrics['acc']:.4f}, "
              f"end batch {hist[-1].batch_size}")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", args.out)
    return out


if __name__ == "__main__":
    main()
