"""What each rank of ``tests/test_torch_scaleout.py`` runs.

A spawned process imports this module (never JAX: the reference runs in
the test process) and calls :func:`run`, which joins a gloo group of
``world`` ranks on the CPU through a ``FileStore``, runs one job and puts
``(rank, result)`` on the queue, or ``(rank, traceback text)`` on failure.
Results are plain Python and numpy values.
"""

from __future__ import annotations

import hashlib
import traceback

import numpy as np
import torch
import torch.distributed as dist

SEQ = 32
POD_EPOCHS, POD_LOST_AT = 4, 3


def run(rank: int, world: int, store_path: str, job: str, args: dict, queue) -> None:
    torch.set_num_threads(1)
    try:
        from repro_torch.launch.mesh import init_ranks

        init_ranks("gloo", store=dist.FileStore(store_path, world), rank=rank,
                   world=world, device="cpu", timeout_s=60)
        out = {name: JOBS[name](args) for name in job.split("+")}
        dist.barrier()
        queue.put((rank, out))
    except BaseException:  # reported to the test process, which fails on it
        queue.put((rank, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def checksum(model) -> float:
    """A float64 checksum of a model's parameters."""
    return float(sum(p.detach().double().sum().item() * (i + 1)
                     for i, p in enumerate(model.parameters())))


# ---------------------------------------------------------------------------
# the LM step data-parallel over the ranks
# ---------------------------------------------------------------------------


def lm_program(pkg):
    """The tick-fired DiveBatch program both packages run (a tick every 3
    steps, granule 4; delta 4 grows the batch at the first tick)."""
    return pkg.AdaptationProgram(
        pkg.DiveBatchPolicy(4, 16, delta=4.0, dataset_size=None, granule=4, on_tick=True),
        0.1, tick_every=3)


def lm_moment(a: dict) -> dict:
    """``for_lm(micro_batch=4, dp_size=2)`` on reduced Yi-6B, sgd with
    momentum: 6 steps under :func:`lm_program`, the signals read and reset
    at steps 3 and 6."""
    from repro_torch import adapt
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.launch.mesh import data_plan
    from repro_torch.interop import params_from_jax, params_to_numpy
    from repro_torch.optim import sgd
    from repro_torch.train import StepEngine, init_state

    cfg = get_config("yi-6b", reduced=True)
    plan = data_plan("cpu")
    eng = StepEngine.for_lm(cfg, sgd(momentum=0.9), micro_batch=4, attn_impl="pallas",
                            dp_size=2, plan=plan)
    state = init_state(params_from_jax(a["lm_params"], cfg), sgd(momentum=0.9))
    program, stream = lm_program(adapt), TokenStream(cfg.vocab_size, seed=1)
    out = {"loss": [], "batch": [], "diversity": [], "checksum": []}
    m = program.batch_size
    for step in range(6):
        state, metrics = eng.step(state, stream.batch(step, m, SEQ), 0.1)
        out["loss"].append(float(metrics["loss"]))
        out["batch"].append(m)
        out["checksum"].append(checksum(state.params))
        if step in (2, 5):
            sig, state = adapt.read_signals(state, "moment", reset=True, batch_size=m)
            program.observe(sig, adapt.Clock(epoch=step // 3, step=step + 1,
                                             boundary="tick"))
            out["diversity"].append(sig.diversity)
            m = program.batch_size
    out["buckets"] = list(eng.stats.buckets)
    out["params"] = params_to_numpy(state.params, cfg)
    return out


def lm_probe_tiers(a: dict) -> dict:
    """3 steps of the exact (``psn_impl="kernel"``) and gram tiers at
    ``num_micro=2, dp_size=2`` on batches of 8."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.launch.mesh import data_plan
    from repro_torch.interop import params_from_jax, params_to_numpy
    from repro_torch.models import probes
    from repro_torch.optim import sgd
    from repro_torch.train import init_state, make_train_step

    cfg = get_config("yi-6b", reduced=True)
    plan = data_plan("cpu")
    hooks = dict(probe_loss=lambda p, pr, b: probes.loss_with_probes(cfg, p, pr, b),
                 probe_specs=lambda p, n: probes.probe_specs(cfg, n, SEQ, device="cpu"))
    out = {}
    for tier in ("exact", "gram"):
        kw = {"psn_impl": "kernel"} if tier == "exact" else {}
        step = make_train_step(cfg, sgd(), 2, dp_size=2, plan=plan, estimator=tier,
                               **kw, **hooks)
        state = init_state(params_from_jax(a["probe_params"], cfg), sgd())
        stream = TokenStream(cfg.vocab_size, seed=3)
        rec = {"loss": [], "sq_norm_sum": [], "checksum": []}
        for i in range(3):
            state, metrics = step(state, stream.batch(i, 8, SEQ), 0.1)
            rec["loss"].append(float(metrics["loss"]))
            rec["sq_norm_sum"].append(state.div_state.sq_norm_sum.item())
            rec["checksum"].append(checksum(state.params))
        rec["params"] = params_to_numpy(state.params, cfg)
        out[tier] = rec
    return out


# ---------------------------------------------------------------------------
# the paper's Trainer on a PodLadder whose pods are ranks
# ---------------------------------------------------------------------------


def record_codes(codes: list):
    """Wrap the compressor's quantiser so each call appends a digest of its
    codes and scale to ``codes``; returns the restore function."""
    from repro_torch.dist import compression

    inner = compression._quantize

    def recording(x):
        q, scale = inner(x)
        codes.append(hashlib.sha1(q.cpu().numpy().tobytes()
                                  + scale.cpu().numpy().tobytes()).hexdigest())
        return q, scale

    compression._quantize = recording
    return lambda: setattr(compression, "_quantize", inner)


def pod_run(devices, ckpt_dir: str) -> dict:
    """``run_supervised`` over a ``PodLadder(pods=2, granule=16)`` on
    ``devices``: the MLP on a small ``sigmoid_synthetic``, DiveBatch on the
    moment tier (delta 1) from m0 64 (rung 2) to 128 (the cross-pod rung 3)
    after the first epoch, pod 1 lost at epoch 3.  Returns the epochs (batch, rung, steps, losses),
    each cross-pod step's scales, the code digests and the parameters."""
    from repro_torch.adapt import AdaptationProgram, DiveBatchPolicy
    from repro_torch.data import sigmoid_synthetic
    from repro_torch.launch.supervisor import run_supervised
    from repro_torch.models import small
    from repro_torch.optim import sgd
    from repro_torch.pod import PodLadder
    from repro_torch.train.loop import ModelFns, Trainer

    train, val, _ = sigmoid_synthetic(n=2500, d=32, seed=0)
    fns = ModelFns(batch_loss=small.mlp_batch_loss, example_loss=small.mlp_loss,
                   metrics=lambda p, b: {"acc": small.mlp_accuracy(p, b)})
    out = {"scales": [], "rungs": [], "codes": []}

    def make_trainer(mgr):
        program = AdaptationProgram(
            DiveBatchPolicy(64, 128, 1.0, dataset_size=len(train), granule=16), 0.1,
            estimator="moment")
        trainer = Trainer(fns, small.mlp_init(torch.Generator().manual_seed(0), 32, 8,
                                              device="cpu"),
                          sgd(momentum=0.9), program, train, val, estimator="moment",
                          ckpt=mgr, elastic=PodLadder(pods=2, devices=devices, granule=16))
        step = trainer.engine.step

        def capture(state, batch, lr):
            new, metrics = step(state, batch, lr)
            out["rungs"].append(trainer.rung.index)
            if "scales" in metrics:
                out["scales"].append(metrics["scales"].numpy().copy())
            return new, metrics

        trainer.engine.step = capture
        out["trainer"] = trainer
        return trainer

    restore = record_codes(out["codes"])
    try:
        history = run_supervised(make_trainer, POD_EPOCHS, [], ckpt_dir,
                                 lose_pod=[POD_LOST_AT])
    finally:
        restore()
    trainer = out.pop("trainer")
    out["epochs"] = [(h.batch_size, h.steps, h.train_loss, h.val_loss, h.diversity)
                     for h in history]
    out["params"] = [p.detach().numpy().copy() for p in trainer.params.parameters()]
    out["final_rung"] = trainer.rung.index
    out["checksum"] = checksum(trainer.params)
    return out


def pod(a: dict) -> dict:
    from repro_torch.dist.plan import rank_devices

    return pod_run(rank_devices("cpu", per_rank=4), a["pod_ckpt"])


# ---------------------------------------------------------------------------
# launch/train.py --dp 2 and --elastic
# ---------------------------------------------------------------------------


def cli(a: dict) -> dict:
    """The paper's CLI on the reference task's weights, ``--dp 2`` and then
    ``--elastic``; each returns its history (the first rank writes
    ``--out``)."""
    from repro_torch import interop
    from repro_torch.launch import train as cli_lib

    build = cli_lib.build_task

    def same_weights(task, seed, device):
        fns, _, train, val = build(task, seed, device)
        return fns, interop.small_params_from_jax(a["cli_weights"]), train, val

    cli_lib.build_task = same_weights
    out = {}
    try:
        for name, flags in (("dp", ["--dp", "2"]), ("elastic", ["--elastic"])):
            res = cli_lib.main(["--device", "cpu", "--backend", "gloo", "--task",
                                "synthetic-convex", "--epochs", "2"] + flags)
            out[name] = {"epochs": [(h.batch_size, h.steps, h.train_loss, h.val_loss)
                                    for h in res["history"]],
                         "checksum": checksum(res["trainer"].params),
                         "reshards": res["trainer"].engine.stats.reshards}
    finally:
        cli_lib.build_task = build
    return out


def pod_mean_trees(seed: int) -> tuple[list, list]:
    """Pod ``seed``'s gradient and residual trees for the exchange check."""
    r = np.random.default_rng(seed)
    shapes = [(33, 7), (5,), (), (2, 3, 4)]
    grads = [torch.from_numpy(np.asarray(r.standard_normal(s), np.float32)) for s in shapes]
    err = [torch.from_numpy(np.asarray(1e-2 * r.standard_normal(s), np.float32))
           for s in shapes]
    return grads, err


def pod_mean(a: dict) -> dict:
    """``compressed_pod_mean`` over the pod group: each rank one pod."""
    from repro_torch.dist.compression import compressed_pod_mean

    rank = dist.get_rank()
    grads, err = pod_mean_trees(rank)
    mean, new_err = compressed_pod_mean([grads], [err], group=dist.group.WORLD,
                                        pod_ranks=list(range(dist.get_world_size())))
    return {"mean": [t.numpy() for t in mean], "err": [t.numpy() for t in new_err[0]]}


JOBS = {"lm_moment": lm_moment, "lm_probe_tiers": lm_probe_tiers, "pod": pod, "cli": cli,
        "pod_mean": pod_mean}
