"""Fault-tolerance supervisor: training with failure injection and
checkpoint/restart, verifying trajectory continuity.

Counterpart of ``repro/launch/supervisor.py``.  The restart path is a fresh
``Trainer`` + ``resume()``; a step-time watchdog flags stragglers.

  python -m repro_torch.launch.supervisor --epochs 12 --fail-at 4 --fail-at 8

With ``--elastic`` the job runs on a ``MeshLadder``: a failure injected
after the batch has grown restarts onto a wider rung (the checkpoint is
topology-free and the resumed Trainer derives its rung from the restored
batch size).  With ``--pods N`` it runs on a ``pod.PodLadder`` and
``--lose-pod EPOCH[:POD]`` injects a host loss: the supervisor marks the pod
lost and demotes onto the widest all-healthy rung (``pod_lost`` / ``demote``
run-log events), no restart.

  python -m repro_torch.launch.supervisor --device cpu --epochs 6 --pods 2 --lose-pod 3

Under ``torchrun`` (``--backend``) the ladder's entries are the world's
ranks: with ``--pods N`` each pod is ``WORLD_SIZE / N`` ranks' worth of
virtual devices, and a lost pod's ranks leave the loop cleanly while the
survivors demote onto groups built at the start.

  torchrun --nproc-per-node 2 -m repro_torch.launch.supervisor --backend gloo \\
      --device cpu --epochs 6 --pods 2 --lose-pod 3
"""

from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np

from repro_torch.utils.logging import get_logger

log = get_logger("supervisor")


class InjectedFailure(RuntimeError):
    pass


class Watchdog:
    """Step-time z-score straggler detector.

    ``on_flag(step, z)`` (optional) fires on every flag; the supervisor wires
    it to ``Trainer.inject_event('straggler')``, an ``event`` boundary the
    adaptation program observes between steps."""

    def __init__(self, window: int = 20, z_thresh: float = 4.0, on_flag=None):
        self.times: list[float] = []
        self.window = window
        self.z_thresh = z_thresh
        self.flagged: list[tuple[int, float]] = []
        self.on_flag = on_flag

    def observe(self, step: int, dt: float):
        self.times.append(dt)
        hist = self.times[-self.window:]
        prev = hist[:-1]
        # a z-score needs at least 2 prior observations; the first check is
        # at the 5th observation where the window allows it
        if len(prev) < max(2, min(4, self.window - 1)):
            return
        mu, sd = float(np.mean(prev)), float(np.std(prev))
        if sd <= 0.0:
            # constant history: floor the spread relative to the mean, so
            # equal times give z = 0 and a real spike still flags
            sd = max(abs(mu), 1e-9) * 1e-3
        z = (dt - mu) / sd
        if z > self.z_thresh:
            self.flagged.append((step, z))
            log.warning("straggler: step %d took %.3fs (z=%.1f)", step, dt, z)
            if self.on_flag is not None:
                self.on_flag(step, z)


def _normalize_losses(lose_pod) -> list[tuple[int, int | None]]:
    """``lose_pod`` items are epochs or ``(epoch, pod)`` pairs; a None pod
    means the last pod."""
    out: list[tuple[int, int | None]] = []
    for item in lose_pod or []:
        if isinstance(item, (tuple, list)):
            e, p = item
            out.append((int(e), int(p)))
        else:
            out.append((int(item), None))
    return out


def _outside(trainer) -> bool:
    """Whether this rank is outside every usable rung of a rank ladder after
    a pod loss (its pod, or a pod after it, is lost)."""
    from repro_torch.dist.plan import process_rank

    ladder = trainer.elastic
    if not trainer.ranked:
        return False
    me = process_rank()
    healthy = ladder.topology.pods[:ladder.health.healthy_prefix]
    return all(d.rank != me for pod in healthy for d in pod)


def run_supervised(make_trainer, total_epochs: int, fail_at: list[int],
                   ckpt_dir: str, max_restarts: int = 10,
                   tracer=None, runlog=None, lose_pod=None) -> list:
    """``make_trainer(ckpt_manager)`` builds a fresh Trainer bound to the
    checkpoint directory.  Failures are injected at the given epochs; each
    crash is answered with a rebuild + resume.  Returns the final history.

    ``lose_pod`` injects host losses (epochs, or ``(epoch, pod)`` pairs) on
    a ``pod.PodLadder`` trainer: the pod is marked lost and the trainer
    demotes onto the widest all-healthy rung with no checkpoint restore
    (``pod_lost`` + ``demote`` run-log events).  Losses survive restarts: a
    rebuilt ladder is re-marked before resume.  On ranks every rank runs
    this function with the same arguments; a rank outside the healthy pods
    returns its history at the loss.

    ``tracer``/``runlog`` are rebound onto every rebuilt Trainer and each
    (re)start is a ``restart`` event, so one trace and one run log span the
    whole supervised run."""
    from repro_torch.ckpt import CheckpointManager

    restarts = 0
    pending_failures = set(fail_at)
    pending_losses = _normalize_losses(lose_pod)
    lost_pods: set[int] = set()
    while True:
        mgr = CheckpointManager(ckpt_dir, keep=3)
        trainer = make_trainer(mgr)
        if tracer is not None or runlog is not None:
            trainer.bind_obs(tracer=tracer, runlog=runlog)
        health = getattr(getattr(trainer, "elastic", None), "health", None)
        if (pending_losses or lost_pods) and health is None:
            raise ValueError(
                "lose_pod injection needs a trainer on a repro_torch.pod.PodLadder "
                "(it has no pod health registry to mark)")
        # a rebuilt trainer has a fresh ladder: re-mark earlier losses BEFORE
        # resume() so the restored rung is already health-filtered
        for p in lost_pods:
            health.mark_lost(p)
        if lost_pods and _outside(trainer):
            return trainer.history
        trainer.resume()
        if health is not None and lost_pods:
            # a start without a checkpoint may sit on an unhealthy rung
            trainer.demote(note="pods lost before restart")
        rung = getattr(trainer, "rung", None)
        if runlog is not None and runlog.enabled:
            runlog.emit("restart", restarts=restarts, epoch=trainer.cursor.epoch,
                        batch_size=trainer.adapt.batch_size,
                        rung=rung.index if rung is not None else None)
        if rung is not None:
            log.info("elastic: %s on rung %d (dp=%d)",
                     "restarted" if restarts else "starting", rung.index, rung.dp)
        # straggler flags feed the trainer's adaptation program as events
        watchdog = Watchdog(on_flag=lambda step, z: trainer.inject_event("straggler"))
        try:
            while trainer.cursor.epoch < total_epochs:
                t0 = time.time()
                ep = trainer.cursor.epoch
                if ep in pending_failures:
                    pending_failures.discard(ep)
                    raise InjectedFailure(f"injected at epoch {ep}")
                for e, p in [lp for lp in pending_losses if lp[0] == ep]:
                    pending_losses.remove((e, p))
                    pod = p if p is not None else health.num_pods - 1
                    cur = trainer.rung
                    src_rung = cur.index if cur is not None else None
                    health.mark_lost(pod)
                    lost_pods.add(pod)
                    if runlog is not None and runlog.enabled:
                        runlog.emit("pod_lost", pod=pod, epoch=ep, rung=src_rung)
                    if _outside(trainer):
                        log.warning("pod %d lost at epoch %d: this rank leaves", pod, ep)
                        return trainer.history
                    ctx = (tracer.span("demote", scope="train", pod=pod, epoch=ep)
                           if tracer is not None else contextlib.nullcontext())
                    with ctx:
                        src_i, dst_i = trainer.demote(note=f"pod {pod} lost")
                    if runlog is not None and runlog.enabled:
                        runlog.emit("demote", src=src_i, dst=dst_i, pods=trainer.rung.pods,
                                    dp=trainer.rung.dp, epoch=ep)
                    log.warning("pod %d lost at epoch %d: DEGRADED rung %s -> %s (dp=%d), "
                                "no restart", pod, ep, src_i, dst_i, trainer.rung.dp)
                trainer.run_epoch()
                trainer.save()
                watchdog.observe(trainer.cursor.epoch, time.time() - t0)
            return trainer.history
        except InjectedFailure as e:
            restarts += 1
            log.warning("FAILURE: %s — restarting (%d/%d)", e, restarts, max_restarts)
            if restarts > max_restarts:
                raise


def main(argv: list[str] | None = None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="under torchrun: join the world's ranks on this backend; the "
                         "ladder's entries are then the ranks")
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--fail-at", type=int, action="append", default=[])
    ap.add_argument("--ckpt-dir", default="runs/supervised")
    ap.add_argument("--method", default="divebatch")
    ap.add_argument("--elastic", action="store_true",
                    help="run on a MeshLadder: a mid-run failure after the batch has "
                         "grown restarts onto a wider rung than the run started on")
    ap.add_argument("--pods", type=int, default=0,
                    help="run on a PodLadder spanning N pods (cross-pod rungs move "
                         "compressed gradients) of 8 virtual devices in all")
    ap.add_argument("--lose-pod", action="append", default=[], metavar="EPOCH[:POD]",
                    help="inject a host loss at EPOCH (of pod POD, default the last "
                         "pod): the supervisor demotes instead of restarting")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="record a Chrome/Perfetto trace spanning every restart")
    ap.add_argument("--runlog", default=None, nargs="?", const="", metavar="PATH",
                    help="write the JSONL run log, restarts included; bare --runlog "
                         "means <--trace DIR>/runlog.jsonl")
    args = ap.parse_args(argv)

    import torch

    from repro_torch import resolve_device
    from repro_torch.adapt import (AdaBatchPolicy, AdaptationProgram, DiveBatchPolicy,
                                   FixedPolicy)
    from repro_torch.data import sigmoid_synthetic
    from repro_torch.dist.plan import rank_devices, world_size
    from repro_torch.elastic import MeshLadder
    from repro_torch.models import small
    from repro_torch.obs import from_cli as obs_from_cli
    from repro_torch.optim import sgd
    from repro_torch.train.loop import ModelFns, Trainer

    if args.backend:
        from repro_torch.launch.mesh import init_ranks

        dev = init_ranks(args.backend, device=args.device)
        devices = rank_devices(dev, per_rank=8 // world_size())
    else:
        dev = resolve_device(args.device)
        devices = [dev] * 8
    train, val, _ = sigmoid_synthetic(n=4000, d=64, seed=0)

    def make_policy():
        # DiveBatch with on_event=True: a straggler flag re-fires the rule
        if args.method == "divebatch":
            return DiveBatchPolicy(64, 1024, delta=0.1, dataset_size=len(train),
                                   granule=16, on_event=True)
        if args.method == "adabatch":
            return AdaBatchPolicy(64, 1024, granule=16)
        return FixedPolicy(64, 1024, granule=16)

    def make_ladder():
        if args.pods:
            from repro_torch.pod import PodLadder

            return PodLadder(pods=args.pods, devices=devices, granule=16)
        return MeshLadder(devices, granule=16) if args.elastic else None

    def make_trainer(mgr):
        fns = ModelFns(batch_loss=small.logreg_batch_loss, example_loss=small.logreg_loss,
                       metrics=lambda p, b: {"acc": small.logreg_accuracy(p, b)})
        program = AdaptationProgram(make_policy(), base_lr=1.0, estimator="exact")
        return Trainer(fns, small.logreg_init(torch.Generator().manual_seed(0), 64,
                                              device=dev),
                       sgd(momentum=0.9), program, train, val, estimator="exact",
                       ckpt=mgr, elastic=make_ladder())

    lose_pod: list = []
    for spec in args.lose_pod:
        e, _, p = str(spec).partition(":")
        lose_pod.append((int(e), int(p)) if p else int(e))
    tracer, runlog = obs_from_cli(
        args.trace, args.runlog,
        meta={"cmd": "supervisor", "method": args.method, "elastic": bool(args.elastic),
              "fail_at": args.fail_at, "pods": args.pods, "lose_pod": args.lose_pod})
    history = run_supervised(make_trainer, args.epochs, args.fail_at, args.ckpt_dir,
                             tracer=tracer, runlog=runlog, lose_pod=lose_pod)
    if tracer is not None:
        print(f"trace: {tracer.save(args.trace)}")
    if runlog is not None:
        runlog.close()
        print(f"runlog: {runlog.path}")
    print(f"completed {len(history)} epochs across restarts; final val acc "
          f"{history[-1].val_metrics.get('acc'):.4f}")
    return history


if __name__ == "__main__":
    main()
