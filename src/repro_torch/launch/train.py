"""Training CLI: the paper's reproductions with adaptive batching.

Counterpart of ``repro/launch/train.py``, with its tasks and flags.
``--method`` picks the ``repro_torch.adapt`` policy (divebatch / adabatch /
sgd / oracle / gns, the gradient-noise-scale family), ``--tick-every N``
adds mid-epoch decisions every N steps, and ``--hysteresis B`` wraps the
policy in a tolerance band around the pow2 bucket thresholds.  Checkpoints
(``--ckpt-dir``, every ``--ckpt-every`` epochs) are in the reference's
format, and ``--resume`` continues from the latest one, wherever it was
written.  The device defaults to ``cuda`` and raises without a Hopper card;
``--device cpu`` runs the plain PyTorch path.  ``--dp N`` trains
data-parallel over N ranks and ``--elastic`` on a ``MeshLadder`` over the
world's ranks (``--dp`` of them, default all); both run under ``torchrun``
(``--backend``, default nccl) and raise without a process group of the
right size.  Their rungs would shard the state by the reference's rules,
but the paper's models match none (``fc1/kernel`` and the like), so every
rank keeps whole leaves and averages its gradients:

  torchrun --nproc-per-node 2 -m repro_torch.launch.train --dp 2
  torchrun --nproc-per-node 2 -m repro_torch.launch.train --device cpu \
      --backend gloo --elastic

Only the first rank prints, traces and writes checkpoints.

Examples:
  python -m repro_torch.launch.train --task synthetic-convex --method divebatch
  python -m repro_torch.launch.train --task imagelike --method adabatch --epochs 30
  python -m repro_torch.launch.train --device cpu --task synthetic-convex \\
      --epochs 4 --ckpt-dir /tmp/ck --ckpt-every 1
  python -m repro_torch.launch.train --device cpu --task synthetic-convex \\
      --epochs 6 --ckpt-dir /tmp/ck --resume

Weights are random from ``--seed``, drawn on the CPU, so a seed gives the
same weights on every device.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
from typing import Any

import torch

from repro_torch import DEFAULT_DEVICE, resolve_device
from repro_torch.adapt import (
    AdaBatchPolicy,
    AdaptationProgram,
    DiveBatchPolicy,
    FixedPolicy,
    GradNoisePolicy,
    Hysteresis,
    LrCoupling,
)
from repro_torch.ckpt import CheckpointManager
from repro_torch.core.controller import step_decay
from repro_torch.data import imagelike_classification, sigmoid_synthetic
from repro_torch.dist.plan import process_rank, use_plan
from repro_torch.launch import mesh as mesh_lib
from repro_torch.obs import from_cli as obs_from_cli
from repro_torch.optim import sgd
from repro_torch.train.loop import ModelFns, Trainer

def rank_setup(args) -> tuple[torch.device, Any, Any]:
    """``(device, plan, ladder)`` for ``--dp`` / ``--elastic``: this
    process's rank joins the world on ``--backend``; ``--dp N`` needs a world
    of N ranks, ``--elastic`` alone at least 2."""
    return mesh_lib.rank_setup(args.backend, dp=args.dp, device=args.device,
                               elastic=args.elastic, granule=args.granule,
                               command="repro_torch.launch.train")


def build_task(task: str, seed: int, device: torch.device | str = "cuda"):
    """``(fns, params, train, val)`` of a task at the reference's sizes."""
    from repro_torch.models import resnet, small

    gen = torch.Generator().manual_seed(seed)
    if task == "synthetic-convex":
        train, val, _ = sigmoid_synthetic(n=20_000, d=512, seed=seed)
        params = small.logreg_init(gen, 512, device=device)
        fns = ModelFns(
            batch_loss=small.logreg_batch_loss,
            example_loss=small.logreg_loss,
            metrics=lambda p, b: {"acc": small.logreg_accuracy(p, b)},
        )
        return fns, params, train, val
    if task == "synthetic-nonconvex":
        train, val, _ = sigmoid_synthetic(n=20_000, d=512, seed=seed)
        params = small.mlp_init(gen, 512, device=device)
        fns = ModelFns(
            batch_loss=small.mlp_batch_loss,
            example_loss=small.mlp_loss,
            metrics=lambda p, b: {"acc": small.mlp_accuracy(p, b)},
            probe_loss=small.mlp_batch_loss_with_probes,
            probe_specs=small.mlp_probe_specs,
        )
        return fns, params, train, val
    if task == "imagelike":
        train, val = imagelike_classification(n=6_000, hw=16, num_classes=10, seed=seed)
        params = resnet.resnet_init(gen, depth=8, width=8, device=device)
        fns = ModelFns(
            batch_loss=resnet.resnet_batch_loss,
            example_loss=resnet.resnet_loss,
            metrics=lambda p, b: {"acc": resnet.resnet_accuracy(p, b)},
        )
        return fns, params, train, val
    raise ValueError(f"unknown task {task!r}")


def make_program(args, dataset_size: int) -> AdaptationProgram:
    """The ``repro_torch.adapt`` program for the CLI flags."""
    common = dict(m0=args.batch_size, m_max=args.max_batch_size, granule=args.granule)
    tick = args.tick_every > 0
    if args.method in ("sgd", "fixed"):
        policy = FixedPolicy(**common)
    elif args.method == "adabatch":
        policy = AdaBatchPolicy(resize_freq=args.resize_freq, **common)
    elif args.method in ("divebatch", "oracle"):
        policy = DiveBatchPolicy(
            delta=args.delta, dataset_size=dataset_size,
            oracle=args.method == "oracle", on_tick=tick, **common,
        )
    elif args.method == "gns":
        policy = GradNoisePolicy(alpha=args.gns_alpha, on_tick=tick, **common)
    else:
        raise ValueError(f"unknown method {args.method!r}")
    if args.hysteresis > 0:
        policy = Hysteresis(policy, band=args.hysteresis)
    decay = step_decay(args.lr_decay, args.lr_decay_every) if args.lr_decay < 1 else None
    return AdaptationProgram(
        policy,
        base_lr=args.lr,
        coupling=LrCoupling(rule=args.lr_rule, decay=decay),
        estimator=args.estimator,
        tick_every=args.tick_every,
    )


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    ap.add_argument("--task", default="synthetic-convex")
    ap.add_argument("--method", default="divebatch",
                    choices=["sgd", "adabatch", "divebatch", "oracle", "gns"])
    ap.add_argument("--estimator", default="exact",
                    choices=["exact", "gram", "moment", "oracle"])
    ap.add_argument("--tick-every", type=int, default=0,
                    help="mid-epoch adaptation: observe the running signals every N "
                         "optimizer steps (0 = epoch boundaries only)")
    ap.add_argument("--gns-alpha", type=float, default=1.0,
                    help="--method gns: target batch = alpha * measured gradient-noise "
                         "scale")
    ap.add_argument("--hysteresis", type=float, default=0.0,
                    help="tolerance band around pow2 bucket thresholds (e.g. 0.1): "
                         "resizes within the band hold the current size")
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--max-batch-size", type=int, default=2048)
    ap.add_argument("--delta", type=float, default=0.1)
    ap.add_argument("--granule", type=int, default=16)
    ap.add_argument("--resize-freq", type=int, default=20)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--lr-rule", default="none", choices=["none", "linear", "sqrt"])
    ap.add_argument("--lr-decay", type=float, default=0.75)
    ap.add_argument("--lr-decay-every", type=int, default=20)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--weight-decay", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dp", type=int, default=0,
                    help="data-parallel ranks (under torchrun, a world of N)")
    ap.add_argument("--elastic", action="store_true",
                    help="co-adapt the ranks with the batch size: a MeshLadder over the "
                         "world's ranks (under torchrun), rung transitions at the "
                         "boundaries that resize the batch")
    ap.add_argument("--backend", default="nccl", choices=["nccl", "gloo"],
                    help="the process group's backend with --dp / --elastic (NCCL needs "
                         "a card per rank; gloo also runs on the CPU)")
    ap.add_argument("--no-donate", action="store_true",
                    help="train a copy of the state each step (debugging)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=5)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--out", default=None,
                    help="write run JSON here: {'history': [epoch records], "
                         "'engine': EngineStats}")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="record a Chrome/Perfetto trace and write DIR/trace.json at exit")
    ap.add_argument("--runlog", default=None, nargs="?", const="", metavar="PATH",
                    help="write the JSONL run log (read it with "
                         "repro_torch.launch.monitor); bare --runlog means "
                         "<--trace DIR>/runlog.jsonl")
    return ap


def main(argv: list[str] | None = None) -> dict:
    """Run the CLI; returns ``{"trainer", "history", "program"}``."""
    args = parser().parse_args(argv)
    if args.method == "oracle":
        args.estimator = "oracle"
    plan = ladder = None
    if args.dp or args.elastic:
        dev, plan, ladder = rank_setup(args)
    else:
        dev = resolve_device(args.device)
    first = process_rank() == 0
    tracer, runlog = obs_from_cli(
        args.trace if first else None, args.runlog if first else None,
        meta={"cmd": "train", "task": args.task, "method": args.method,
              "estimator": args.estimator, "seed": args.seed,
              "elastic": bool(args.elastic), "device": str(dev)},
    )
    fns, params, train, val = build_task(args.task, args.seed, dev)
    program = make_program(args, len(train))
    with use_plan(plan) if plan is not None else contextlib.nullcontext():
        trainer = Trainer(
            fns, params, sgd(momentum=args.momentum, weight_decay=args.weight_decay),
            program, train, val,
            estimator=args.estimator if args.method in ("divebatch", "oracle", "gns")
            else "none",
            seed=args.seed,
            ckpt=CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None,
            ckpt_every=args.ckpt_every,
            donate=not args.no_donate,
            elastic=ladder,
            tracer=tracer,
            runlog=runlog,
        )
    if args.resume and trainer.ckpt:
        trainer.resume()
    remaining = args.epochs - trainer.cursor.epoch
    history = trainer.run(max(remaining, 0), verbose=first)
    if not first:
        return {"trainer": trainer, "history": history, "program": program}
    if tracer is not None:
        print(f"trace: {tracer.save(args.trace)}")
    if runlog is not None:
        runlog.close()
        print(f"runlog: {runlog.path}")
    stats = trainer.engine.stats
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"history": [dataclasses.asdict(r) for r in history],
                       "engine": stats.as_dict()}, f, indent=1)
    final = history[-1] if history else None
    if final:
        print(f"final: epoch={final.epoch} val_loss={final.val_loss:.4f} "
              f"metrics={final.val_metrics} batch={final.batch_size}")
    print(f"engine: compiles={stats.compiles} (bound {program.compile_bound}) "
          f"hits={stats.bucket_hits} buckets={stats.buckets} "
          f"dispatch-steps/s={stats.dispatch_steps_per_sec:.1f} donated={stats.donate}")
    mid = [a for a in program.history if a.boundary != "epoch"]
    if mid:
        print(f"adapt: {len(mid)} mid-epoch decisions "
              f"({sum(a.rescaled for a in mid)} resized) via "
              f"{sorted(set(a.boundary for a in mid))}")
    if ladder is not None:
        print(f"elastic: ladder dp={ladder.widths} reshards={stats.reshards} "
              f"rungs-per-compile={stats.rungs}")
    return {"trainer": trainer, "history": history, "program": program}


if __name__ == "__main__":
    main()
