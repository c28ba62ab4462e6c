"""What each rank of the process-group tests (``tests/test_torch_scaleout.py``,
``test_torch_sharded.py``, ``test_torch_moe_ep.py``,
``test_torch_serve_elastic.py``, ``test_torch_dryrun_ranks.py``,
``test_torch_tensor_parallel.py``, ``test_torch_serve_tp.py``) runs.

A spawned process imports this module (never JAX: the reference runs in
the test process) and calls :func:`run`, which joins a gloo group of
``world`` ranks on the CPU through a ``FileStore``, runs one job and puts
``(rank, result)`` on the queue, or ``(rank, traceback text)`` on failure.
Results are plain Python and numpy values.
"""

from __future__ import annotations

import hashlib
import math
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
    """A float64 checksum of a model's parameters, whole (a sharded model's
    are gathered first: a collective over its rung)."""
    from repro_torch.dist import sharding

    layout = sharding.layout_of(model)
    params = [p.detach() if layout is None else layout.unshard(n, p.detach())
              for n, p in model.named_parameters()]
    return float(sum(p.double().sum().item() * (i + 1) for i, p in enumerate(params)))


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


def lm_moe(a: dict) -> dict:
    """3 moment-tier steps of reduced dbrx-132b at ``num_micro=2,
    dp_size=2, moe_groups=2`` on batches of 8: each rank routes one group,
    its share of each microbatch.  ``moe_groups=1`` (a group across the
    ranks) is refused."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.launch.mesh import data_plan
    from repro_torch.interop import params_from_jax, params_to_numpy
    from repro_torch.optim import sgd
    from repro_torch.train import init_state, make_train_step

    cfg = get_config("dbrx-132b", reduced=True)
    plan = data_plan("cpu")
    try:
        make_train_step(cfg, sgd(), 2, dp_size=2, plan=plan, moe_groups=1)
        refused = False
    except ValueError:
        refused = True
    step = make_train_step(cfg, sgd(momentum=0.9), 2, dp_size=2, plan=plan, moe_groups=2)
    state = init_state(params_from_jax(a["moe_params"], cfg), sgd(momentum=0.9))
    stream = TokenStream(cfg.vocab_size, seed=4)
    out = {"loss": [], "moe_aux": [], "sq_norm_sum": [], "checksum": [], "refused": refused}
    for i in range(3):
        state, metrics = step(state, stream.batch(i, 8, SEQ), 0.1)
        out["loss"].append(float(metrics["loss"]))
        out["moe_aux"].append(float(metrics["moe_aux"]))
        out["sq_norm_sum"].append(state.div_state.sq_norm_sum.item())
        out["checksum"].append(checksum(state.params))
    out["params"] = params_to_numpy(state.params, cfg)
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


# ---------------------------------------------------------------------------
# the sharded state (tests/test_torch_sharded.py, tests/test_torch_moe_ep.py)
# ---------------------------------------------------------------------------


def rung_plan(shape: tuple):
    """The widest rung of a ``MeshLadder`` over the world's ranks: ``(data,)``
    or ``(data, model)`` (``fsdp = ep = data``, ``tp = model``)."""
    from repro_torch.dist.plan import rank_devices
    from repro_torch.elastic import MeshLadder

    model = (("model", shape[1]),) if len(shape) > 1 else ()
    return MeshLadder(rank_devices("cpu"), model_axes=model).full.plan


def _whole_numpy(model) -> dict:
    from repro_torch.dist import sharding

    layout = sharding.layout_of(model)
    return {n: (p.detach() if layout is None else layout.unshard(n, p.detach())).numpy()
            for n, p in model.named_parameters()}


def sharded_train(a: dict) -> dict:
    """Each case of ``a["cases"]`` on the rung ``a["shape"]``: the model
    from the reference weights ``a[case["params"]]``, placed sharded, then
    steps of ``make_train_step`` (or, with ``program``, of
    ``StepEngine.for_lm`` under :func:`lm_program`)."""
    from repro_torch import adapt
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.dist import sharding
    from repro_torch.elastic.reshard import place
    from repro_torch.interop import params_from_jax
    from repro_torch.models import probes
    from repro_torch.models import transformer as tf
    from repro_torch.optim import sgd
    from repro_torch.train import StepEngine, init_state, make_train_step

    plan = rung_plan(tuple(a["shape"]))
    out = {}
    for case in a["cases"]:
        cfg = get_config(case["arch"], reduced=True).replace(**case.get("extra", {}))
        opt = sgd(momentum=0.9)
        model = place(params_from_jax(a[case["params"]], cfg), plan)
        state = init_state(model, opt)
        tier = case.get("tier", "moment")
        kw = {}
        if tier == "gram":
            kw = dict(probe_loss=lambda p, pr, b: probes.loss_with_probes(cfg, p, pr, b),
                      probe_specs=lambda p, n: probes.probe_specs(cfg, n, SEQ, device="cpu"))
        elif tier == "exact":
            kw = dict(example_loss=lambda p, e: tf.loss_fn(
                cfg, p, {k: v[None] for k, v in e.items()})[0], psn_chunk=2)
        stream = TokenStream(cfg.vocab_size, seed=case["seed"])
        layout = sharding.layout_of(state.params)
        if cfg.moe_impl == "ep":
            rec_bwd = _ep_backward_outside_the_plan(cfg, state.params, plan, stream)
        else:
            rec_bwd = None
        rec = {"loss": [], "sq_norm_sum": [], "batch": [], "diversity": [],
               "held": sum(p.numel() for p in state.params.parameters()),
               "reckoned": layout.numel(), "sharded": sum(1 for x in layout.leaves if x.dims)}
        if case.get("program"):
            eng = StepEngine.for_lm(cfg, opt, micro_batch=4, dp_size=plan.dp_size, plan=plan,
                                    attn_impl="pallas")
            program = lm_program(adapt)
            m = program.batch_size
            for step in range(6):
                state, metrics = eng.step(state, stream.batch(step, m, SEQ), 0.1)
                rec["loss"].append(float(metrics["loss"]))
                rec["batch"].append(m)
                if step in (2, 5):
                    sig, state = adapt.read_signals(state, "moment", reset=True, batch_size=m)
                    program.observe(sig, adapt.Clock(epoch=step // 3, step=step + 1,
                                                     boundary="tick"))
                    rec["diversity"].append(sig.diversity)
                    m = program.batch_size
            rec["buckets"] = list(eng.stats.buckets)
        else:
            step = make_train_step(cfg, opt, 2, plan=plan, estimator=tier,
                                   moe_groups=case.get("moe_groups", 1), **kw)
            for i in range(case.get("steps", 3)):
                state, metrics = step(state, stream.batch(i, 8, SEQ), 0.1)
                rec["loss"].append(float(metrics["loss"]))
                rec["sq_norm_sum"].append(state.div_state.sq_norm_sum.item())
        rec["params"] = _whole_numpy(state.params)
        rec["ep_backward"] = rec_bwd
        out[case["name"]] = rec
    return out


def _ep_backward_outside_the_plan(cfg, params, plan, stream) -> bool:
    """The remat recompute of a ``moe_impl="ep"`` layer runs in the backward,
    which the autograd engine runs on its own thread on a card, outside the
    step's ``use_plan``: a gradient taken outside the plan must equal the
    one taken inside it."""
    from repro_torch.dist.plan import use_plan
    from repro_torch.models import transformer as tf

    cfg = cfg.replace(remat=True)
    k = plan.mesh.local_positions(plan.dp)[0]
    batch = {n: torch.as_tensor(v[2 * k:2 * k + 2]) for n, v in stream.batch(99, 4, SEQ).items()}
    leaves = list(params.parameters())
    with use_plan(plan):
        inside = torch.autograd.grad(tf.loss_fn(cfg, params, batch)[0], leaves)
        loss = tf.loss_fn(cfg, params, batch)[0]
    outside = torch.autograd.grad(loss, leaves)
    return all(torch.equal(a, b) for a, b in zip(inside, outside))


class _SumBack(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over ``group`` (an
    input replicated over it, each rank reading its own part)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def sharded_collectives(a: dict) -> dict:
    """shard/unshard round trips, bit for bit, and ``gradcheck`` in float64
    of the gather over each axis of the rung ``a["shape"]`` (an input
    replicated over the axis, sliced, gathered; its gradient summed over
    the axis: the Jacobian is the identity on every rank when the gather's
    backward is its adjoint)."""
    from repro_torch.dist import sharding
    from repro_torch.dist.plan import gather_shards

    plan = rung_plan(tuple(a["shape"]))
    mesh = plan.mesh
    r = np.random.default_rng(0)
    out = {"roundtrip": []}
    for shape, spec in a["specs"]:
        x = torch.from_numpy(r.standard_normal(shape).astype(np.float32))
        spec = tuple(tuple(e) if isinstance(e, list) else e for e in spec)
        part = sharding.shard(x, spec, plan)
        out["roundtrip"].append((list(part.shape), bool(torch.equal(
            sharding.unshard(part, spec, plan), x))))
        tree = {"params/pos0/ffn/w_up/kernel": x.clone()}
        back = sharding.unshard_tree(sharding.shard_tree(tree, plan),
                                     {k: v.shape for k, v in tree.items()}, plan)
        out["roundtrip"].append((None, bool(torch.equal(back["params/pos0/ffn/w_up/kernel"],
                                                        x))))
    out["gradcheck"] = {}
    for axes in mesh.axis_names:
        n = mesh.shape[axes]
        z = torch.from_numpy(r.standard_normal((2 * n, 3))).double().requires_grad_(True)

        def fn(z, axes=axes, n=n):
            k = mesh.coords()[axes]
            mine = _SumBack.apply(z, mesh.group(axes))[k * 2:(k + 1) * 2]
            return gather_shards([mine], [[(0, (axes,))]], mesh, plan.dp)[0] * 1.5

        out["gradcheck"][axes] = bool(torch.autograd.gradcheck(fn, (z,), eps=1e-6,
                                                               atol=1e-8))
    return out


def _ckpt_state(plan, params):
    from repro_torch.configs import get_config
    from repro_torch.elastic.reshard import place
    from repro_torch.interop import params_from_jax
    from repro_torch.optim import sgd
    from repro_torch.train import init_state, make_train_step

    cfg = get_config("yi-6b", reduced=True)
    opt = sgd(momentum=0.9)
    state = init_state(place(params_from_jax(params, cfg), plan), opt)
    return cfg, state, make_train_step(cfg, opt, 2, plan=plan)


def sharded_ckpt(a: dict) -> dict:
    """Two steps of reduced Yi-6B sharded on the ranks, saved through the
    rung (rank 0 writes ``sharded``), then the state gathered whole and
    saved by rank 0 alone (``whole``); then a third step."""
    from repro_torch import interop
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.data import TokenStream
    from repro_torch.elastic.reshard import unshard_state

    plan = rung_plan((dist.get_world_size(),))
    cfg, state, step = _ckpt_state(plan, a["ckpt_params"])
    stream = TokenStream(cfg.vocab_size, seed=12)
    for i in range(2):
        state, _ = step(state, stream.batch(i, 8, SEQ), 0.1)
    ref = interop.reference_state(state)
    tree = {"params": ref.params, "opt_state": ref.opt_state, "div_state": ref.div_state}
    CheckpointManager(a["root"] + "/sharded").save(
        2, tree, group=plan.mesh.group(plan.mesh.axis_names), root=0)
    held = sum(p.numel() for p in state.params.parameters())
    state, metrics = step(state, stream.batch(2, 8, SEQ), 0.1)
    next_loss = float(metrics["loss"])
    # the whole state of step 2, once more, saved by one process
    cfg, state, step = _ckpt_state(plan, a["ckpt_params"])
    stream = TokenStream(cfg.vocab_size, seed=12)
    for i in range(2):
        state, _ = step(state, stream.batch(i, 8, SEQ), 0.1)
    whole = unshard_state(state)
    if dist.get_rank() == 0:
        ref = interop.reference_state(whole)
        CheckpointManager(a["root"] + "/whole").save(
            2, {"params": ref.params, "opt_state": ref.opt_state,
                "div_state": ref.div_state})
    return {"next_loss": next_loss, "step": 2, "held": held}


def sharded_restore(a: dict) -> dict:
    """Restore ``sharded_ckpt``'s save onto the rung ``a["shape"]`` (a state
    from other weights, placed first) and take its third step."""
    from repro_torch import interop
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.elastic.reshard import place
    from repro_torch.models import transformer as tf
    from repro_torch.optim import sgd
    from repro_torch.train import init_state, make_train_step

    plan = rung_plan(tuple(a["shape"]))
    cfg = get_config("yi-6b", reduced=True)
    opt = sgd(momentum=0.9)
    state = init_state(place(tf.init_params(cfg, torch.Generator().manual_seed(5), "cpu"),
                             plan), opt)
    mgr = CheckpointManager(a["root"] + "/sharded")
    ref = interop.reference_state(state, target=True)
    out, _ = mgr.restore({"params": ref.params, "opt_state": ref.opt_state,
                          "div_state": ref.div_state})
    state = interop.load_reference_state(state, step=2, **out)
    step = make_train_step(cfg, opt, 2, plan=plan)
    state, metrics = step(state, TokenStream(cfg.vocab_size, seed=12).batch(2, 8, SEQ), 0.1)
    return {"loss": float(metrics["loss"]), "step": 2}


def moe_ep(a: dict) -> dict:
    """``moe_apply_ep`` on the 8 ranks of a ``(pod 2, data 2, model 2)``
    mesh (``dp = ep = (pod, data)``, ``tp = model``), the reference test's:
    this rank's rows of ``a["x"]``, its 2 of the 8 experts resident, at each
    capacity factor of ``a["factors"]``: the output rows, the aux loss, the
    drops, and the gradients of ``sum(y ** 2)`` on the resident experts."""
    from repro_torch.dist.plan import Mesh, ShardingPlan, rank_devices
    from repro_torch.models.moe import init_moe
    from repro_torch.models.moe_ep import moe_apply_ep

    mesh = Mesh(np.asarray(rank_devices("cpu"), dtype=object).reshape(2, 2, 2),
                ("pod", "data", "model"))
    plan = ShardingPlan(mesh=mesh, dp=("pod", "data"), fsdp=("pod", "data"), tp="model",
                        ep=("pod", "data"))
    c = mesh.coords()
    k = c["pod"] * 2 + c["data"]
    w = a["moe"]
    e, d, f = w["w_gate"].shape
    layer = init_moe(d, f, e, device="cpu", dtype=torch.float32)
    e_loc = e // 4
    with torch.no_grad():
        layer.router.weight.copy_(torch.from_numpy(w["router"]["kernel"]).t())
        for name in ("w_gate", "w_up", "w_out"):
            part = torch.from_numpy(w[name])[k * e_loc:(k + 1) * e_loc]
            setattr(layer, name, torch.nn.Parameter(part.clone()))
    x = torch.from_numpy(a["x"])[k:k + 1]
    out = {}
    for factor in a["factors"]:
        layer.zero_grad()
        layer.stats = {}
        y, aux = moe_apply_ep(layer, x, top_k=2, capacity_factor=factor, act="silu",
                              mesh=mesh, ep_axes=plan.ep)
        (y ** 2).sum().backward()
        out[factor] = {"y": y.detach().numpy(), "aux": float(aux), "row": k,
                       "dropped": int(layer.stats["dropped"]),
                       "grads": {n: getattr(layer, n).grad.numpy()
                                 for n in ("w_gate", "w_up", "w_out")}}
    return out


def sharded_rungs(a: dict) -> dict:
    """Reduced Yi-6B across the rungs of a 2-rank ``MeshLadder``: placed
    sharded on the 2-rank rung, a step; onto the 1-rank rung (rank 1 leaves
    with the state gathered and waits), a step; back onto 2 ranks, a step.
    Each rank's losses and held elements, and the final parameters whole."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.dist import sharding
    from repro_torch.dist.plan import rank_devices
    from repro_torch.elastic import MeshLadder, reshard
    from repro_torch.interop import params_from_jax
    from repro_torch.optim import sgd
    from repro_torch.train import init_state, make_train_step

    cfg = get_config("yi-6b", reduced=True)
    ladder = MeshLadder(rank_devices("cpu"))
    one, two = ladder.rungs[0].plan, ladder.rungs[1].plan
    opt = sgd(momentum=0.9)
    state = init_state(params_from_jax(a["rungs_params"], cfg), opt)
    stream = TokenStream(cfg.vocab_size, seed=13)
    out = {"loss": [], "held": [], "same": None}
    src = None
    for i, plan in enumerate((two, one, two)):
        kept = state
        state = reshard(state, src, plan, donate=True)
        src = plan
        if not plan.mesh.is_member:
            out["same"] = state is kept and sharding.layout_of(state.params) is None
            continue
        step = make_train_step(cfg, opt, 2, plan=plan)
        state, metrics = step(state, stream.batch(i, 8, SEQ), 0.1)
        out["loss"].append(float(metrics["loss"]))
        out["held"].append(sum(p.numel() for p in state.params.parameters()))
    out["params"] = _whole_numpy(state.params)
    return out


# ---------------------------------------------------------------------------
# elastic serving over the ranks (tests/test_torch_serve_elastic.py)
# ---------------------------------------------------------------------------


def serve_ramp(eng, reqs) -> tuple[list, set]:
    """The reference's live-transition script: one request, two steps, two
    more, two steps, the rest, drain.  The tokens and the rung indices seen."""
    rids = [eng.submit(reqs[0])]
    for _ in range(2):
        eng.step()
    seen = {getattr(eng.rung, "index", None)}
    rids += [eng.submit(r) for r in reqs[1:3]]
    for _ in range(2):
        eng.step()
    seen.add(getattr(eng.rung, "index", None))
    rids += [eng.submit(r) for r in reqs[3:]]
    while eng.step():
        seen.add(getattr(eng.rung, "index", None))
    return [eng.result(rid).tokens.tolist() for rid in rids], seen


def _pool_digest(pages: dict) -> str:
    """A digest of every pool block but the sentinel block 0 (inactive lanes
    write garbage there by design).  A rank outside the live rung holds a
    stale pool until it enters again."""
    h = hashlib.sha256()
    for entry in pages.values():
        for x in entry.values():
            h.update(x[:, 1:].contiguous().numpy().tobytes())
    return h.hexdigest()


def serve_ranks(a: dict) -> dict:
    """Reduced Yi-6B, gemma2-27b and falcon-mamba-7b served on
    ``MeshLadder(rank_devices("cpu"), granule=1)`` through
    :func:`serve_ramp`; reduced Yi-6B under ``use_plan`` of the 2-rank rung;
    and the serving entry points on a sharded module against the whole."""
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding
    from repro_torch.dist.plan import rank_devices, use_plan
    from repro_torch.elastic import MeshLadder
    from repro_torch.elastic.reshard import place
    from repro_torch.interop import params_from_jax
    from repro_torch.models import transformer as tf
    from repro_torch.serve import Request, ServeEngine

    def reqs():
        return [Request(prompt=p, max_new_tokens=m) for p, m in zip(a["prompts"], a["max_new"])]

    kw = dict(max_slots=8, max_seq=a["max_seq"], prompt_granule=a["granule"], block_size=8,
              prefill_chunk=8)
    out = {}
    for arch in ("yi-6b", "gemma2-27b", "falcon-mamba-7b"):
        cfg = get_config(arch, reduced=True)
        eng = ServeEngine(cfg, params_from_jax(a["trees"][arch], cfg),
                          elastic=MeshLadder(rank_devices("cpu"), granule=1), **kw)
        held = {}
        step = eng.step

        def held_step(eng=eng, step=step, held=held):
            more = step()
            layout = sharding.layout_of(eng.params)
            if eng.rung.index == 1:  # both ranks on the rung: the pools must agree
                held["pool"] = _pool_digest(eng._pages)
            if layout is not None and "held" not in held:
                held["held"] = sum(p.numel() for p in eng.params.parameters())
                held["reckoned"] = layout.numel()
                held["whole"] = sum(math.prod(s) for s in sharding.full_shapes(eng.params).values())
            return more

        eng.step = held_step
        toks, _ = serve_ramp(eng, reqs())
        st = eng.stats
        out[arch] = {"tokens": toks, "rungs": list(st.rungs), "buckets": list(st.buckets),
                     "reshards": st.reshards, "resizes": st.resizes, **held}
    cfg = get_config("yi-6b", reduced=True)
    two = MeshLadder(rank_devices("cpu")).full.plan
    with use_plan(two):
        eng = ServeEngine(cfg, params_from_jax(a["trees"]["yi-6b"], cfg), **kw)
        res = eng.generate(reqs())
    out["fixed"] = {"tokens": [r.tokens.tolist() for r in res], "rungs": list(eng.stats.rungs),
                    "buckets": list(eng.stats.buckets), "reshards": eng.stats.reshards}
    out["entries"] = _sharded_entries(cfg, a["trees"]["yi-6b"], two, a["max_seq"])
    try:  # the experts would stay resident: refused on ranks
        ServeEngine(cfg.replace(moe_impl="ep"), params_from_jax(a["trees"]["yi-6b"], cfg),
                    elastic=MeshLadder(rank_devices("cpu"), granule=1), **kw)
        out["ep_refused"] = ""
    except NotImplementedError as e:
        out["ep_refused"] = str(e)
    return out


def _sharded_entries(cfg, tree, plan, max_seq: int) -> dict:
    """``prefill_step``, ``prefill_chunk`` then paged ``decode_step`` on a
    module sharded on ``plan`` and on the whole module: the largest gap of
    every output (logits, caches, pools)."""
    from repro_torch.dist import sharding
    from repro_torch.elastic.reshard import place
    from repro_torch.interop import params_from_jax
    from repro_torch.models import transformer as tf

    whole = params_from_jax(tree, cfg)
    shard = place(params_from_jax(tree, cfg), plan)
    r = np.random.default_rng(17)
    toks = torch.from_numpy(r.integers(1, cfg.vocab_size, size=(2, 16)))
    chunk = torch.from_numpy(r.integers(1, cfg.vocab_size, size=(1, 16)))

    def gap(x, y):
        if isinstance(x, dict):
            return max((gap(x[k], y[k]) for k in x), default=0.0)
        return float((x.double() - y.double()).abs().max())

    def serve(model):
        pre = tf.prefill_step(cfg, model, {"tokens": toks})
        pages = tf.init_pages(cfg, 8, 8, device="cpu")
        row = tf.init_cache(cfg, 1, max_seq, skip=tf.paged_positions(cfg), device="cpu")
        row["len"] = torch.zeros((1,), dtype=torch.int32)
        tab = torch.tensor([1, 2])
        lc, row, pages = tf.prefill_chunk(cfg, model, row, pages, {"tokens": chunk}, 0,
                                          torch.zeros((0,), dtype=torch.int64), tab)
        tables = torch.tensor([[1, 2, 3, 0]])
        ld, _, pages = tf.decode_step(cfg, model, row, chunk[:, -1:], pages=pages,
                                      tables=tables)
        return {"prefill_step": pre, "prefill_chunk": (lc, row), "decode_step": (ld, pages)}

    a, b = serve(whole), serve(shard)
    out = {"sharded": sharding.layout_of(shard) is not None}
    for k in ("prefill_step", "prefill_chunk", "decode_step"):
        out[k] = max(gap(x, y) for x, y in zip(a[k], b[k]))
    return out


def serve_cli(a: dict) -> dict:
    """``launch.serve --device cpu --elastic --backend gloo`` on the ranks;
    on rank 0 also the one-process CLI on the same flags without a ladder."""
    import contextlib
    import io

    from repro_torch.launch import serve as launch_serve

    flags = ["--device", "cpu", "--requests", "6", "--ramp", "2", "--max-new", "6",
             "--prefill-chunk", "8", "--block-size", "8"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = launch_serve.main(flags + ["--elastic", "--backend", "gloo", "--out", a["out"]])
    out = {"tokens": [r.tokens.tolist() for r in got["results"]], "out": buf.getvalue()}
    if dist.get_rank() == 0:
        with contextlib.redirect_stdout(io.StringIO()):
            one = launch_serve.main(flags)
        out["one"] = [r.tokens.tolist() for r in one["results"]]
    return out


def dryrun_collectives(a: dict) -> dict:
    """For each case of ``a["cases"]``, one ``make_train_step`` step of
    ``num_micro`` microbatches on the 2-rank ``(data 2)`` rung with the
    state sharded, and the collectives the ``dist.plan`` helpers issued in
    it: ``{kind: [count, operand bytes]}`` (what the dry run's trace of the
    same cell in a fake world must give)."""
    from repro_torch.configs import get_config
    from repro_torch.data import TokenStream
    from repro_torch.dist.plan import record_collectives
    from repro_torch.elastic.reshard import place
    from repro_torch.models import transformer as tf
    from repro_torch.optim import sgd
    from repro_torch.train import init_state, make_train_step

    plan = rung_plan((2,))
    out = {}
    for case in a["cases"]:
        cfg = get_config(case["arch"], reduced=True).replace(**case.get("extra", {}))
        opt = sgd(momentum=0.9)
        model = place(tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu"), plan)
        state = init_state(model, opt)
        step = make_train_step(cfg, opt, case["num_micro"], plan=plan,
                               moe_groups=case.get("moe_groups", 1))
        batch = TokenStream(cfg.vocab_size, seed=0).batch(0, case["batch"], case["seq"])
        seen: dict = {}

        def record(kind, operand, result, ranks):
            c = seen.setdefault(kind, [0, 0])
            c[0] += 1
            c[1] += operand

        with record_collectives(record):
            step(state, batch, 0.1)
        out[case["name"]] = seen
    return out


# ---------------------------------------------------------------------------
# tensor-parallel compute (tests/test_torch_tensor_parallel.py)
# ---------------------------------------------------------------------------


def tp_batch(cfg, seed: int, step: int, n: int) -> dict:
    """Step ``step``'s batch of ``n`` sequences of ``SEQ``: tokens from
    ``TokenStream``, or for an embedding-input config N(0, 1) frames and
    uniform targets from ``numpy.random.default_rng((seed, step))``."""
    if cfg.input_mode == "tokens":
        from repro_torch.data import TokenStream

        return TokenStream(cfg.vocab_size, seed=seed).batch(step, n, SEQ)
    r = np.random.default_rng((seed, step))
    return {"embeddings": r.standard_normal((n, SEQ, cfg.d_model), dtype=np.float32),
            "targets": r.integers(0, cfg.vocab_size, size=(n, SEQ)).astype(np.int32)}


class SplitSpy:
    """Records, while active, the head counts ``(query, KV)`` that
    ``transformer._self_attention`` sees and its ``(query rows, query
    offset, keys)``, the hidden widths of the dense FFNs' products and the
    experts' widths ``moe_apply`` runs, the result bytes of the all-gathers
    issued inside block entries (the context-parallel exchanges apart) and
    of those the input and the head issue (``_model_input``, ``_xent``: the
    training forward's and the probe pass's), the collectives of the
    context-parallel exchanges (``_context_qkv``, ``_context_out``) as
    ``(kind, result bytes)``, the shapes in which the embedding, the
    frontend and the head reach the compute (``_whole``, ``_tp_shard``),
    the channels the Mamba scan runs (``ssm._scan``' ``dt`` and ``A_log``)
    and the weights the mixers' products see (``ssm.dense``)."""

    def __init__(self):
        self.heads, self.ffn, self.moe, self.rows = set(), set(), set(), set()
        self.scan, self.mamba_weights = set(), set()
        self.block_gather_bytes = 0
        self.vocab_gathers: list[int] = []
        self.context_colls: list[tuple[str, int]] = []
        self.leaves: set = set()

    def __enter__(self):
        from repro_torch.models import ssm
        from repro_torch.models import transformer as tf

        self.saved = (tf._self_attention, tf.FFN.forward, tf.moe_apply, tf._gathered_block,
                      tf._whole, tf._tp_shard, tf._model_input, tf._xent, tf._context_qkv,
                      tf._context_out)
        self.saved_ssm = (ssm._scan, ssm.dense)
        scan, sdense = self.saved_ssm

        def spy_scan(layer, h, dt, *args):
            self.scan.add((dt.shape[-1], layer.A_log.shape[0], h.shape[1]))
            return scan(layer, h, dt, *args)

        def spy_sdense(x, weight, *args, **kw):
            self.mamba_weights.add(tuple(weight.shape))
            return sdense(x, weight, *args, **kw)

        ssm._scan, ssm.dense = spy_scan, spy_sdense
        (attn, ffn_fwd, moe, block, whole, tp_shard, model_input, xent, context_qkv,
         context_out) = self.saved
        inside, vocab, context = [False], [False], [False]

        def flagged(fn, flag=vocab):
            def call(*args):
                flag[0] = True
                try:
                    return fn(*args)
                finally:
                    flag[0] = False
            return call

        def spy_whole(params, name):
            out = whole(params, name)
            self.leaves.add((name, tuple(out.shape)))
            return out

        def spy_tp_shard(params, name, tp):
            out, dim = tp_shard(params, name, tp)
            self.leaves.add((name, tuple(out.shape)))
            return out, dim

        def spy_attn(cfg, q, k, v, window, causal, q_offset=0, seq=None):
            self.heads.add((q.shape[2], k.shape[2]))
            self.rows.add((q.shape[1], q_offset, k.shape[1]))
            return attn(cfg, q, k, v, window, causal, q_offset, seq)

        def spy_ffn(mod, x):
            self.ffn.add((mod.w_up if mod.glu else mod.w_in).weight.shape[0])
            return ffn_fwd(mod, x)

        def spy_moe(params, x, **kw):
            self.moe.add(params.w_gate.shape[-1])
            return moe(params, x, **kw)

        def spy_block(*args):
            inside[0] = True
            try:
                return block(*args)
            finally:
                inside[0] = False

        def record(kind, operand, result, ranks):
            if context[0]:
                self.context_colls.append((kind, result))
            elif kind == "all-gather" and inside[0]:
                self.block_gather_bytes += result
            elif kind == "all-gather" and vocab[0]:
                self.vocab_gathers.append(result)

        from repro_torch.dist.plan import record_collectives

        self.recording = record_collectives(record)
        self.recording.__enter__()
        (tf._self_attention, tf.FFN.forward, tf.moe_apply, tf._gathered_block, tf._whole,
         tf._tp_shard, tf._model_input, tf._xent, tf._context_qkv, tf._context_out) = (
            spy_attn, spy_ffn, spy_moe, spy_block, spy_whole, spy_tp_shard,
            flagged(model_input), flagged(xent), flagged(context_qkv, context),
            flagged(context_out, context))
        return self

    def __exit__(self, *exc):
        from repro_torch.models import ssm
        from repro_torch.models import transformer as tf

        (tf._self_attention, tf.FFN.forward, tf.moe_apply, tf._gathered_block, tf._whole,
         tf._tp_shard, tf._model_input, tf._xent, tf._context_qkv,
         tf._context_out) = self.saved
        ssm._scan, ssm.dense = self.saved_ssm
        self.recording.__exit__(*exc)


def block_gather_reckoning(cfg, model) -> int:
    """The bytes a forward's block entries gather on this rank, from the
    layout and ``tp_split``: each leaf over its sharded dims' axes, round by
    round in mesh order (a round's result is the leaf whole over the axes
    so far), but for the tp dim a split block keeps resident."""
    from repro_torch.dist import sharding

    layout = sharding.layout_of(model)
    size = {n: p.element_size() for n, p in model.named_parameters()}
    total = 0
    for leaf in layout.leaves:
        if not leaf.name.startswith("blocks."):
            continue
        _, i, name = leaf.name.split(".", 2)
        split = sharding.tp_split(cfg, int(i) % cfg.period, layout.plan)
        keep = layout.resident(leaf, split.role(name))
        n = math.prod(layout.local_shape(leaf.name)) * size[leaf.name]
        for d, axes in sorted((e for e in leaf.dims if e not in keep),
                              key=lambda e: [layout.mesh.axis_names.index(a) for a in e[1]]):
            n *= layout.plan.axis_size(axes)
            total += n
    return total


def tp_train(a: dict) -> dict:
    """Each case of ``a["cases"]`` on its rung ``case["shape"]`` (``(data,
    model)``), its blocks split over the model axis: the model from the
    reference weights ``a[case["params"]]``, placed sharded, then steps of
    ``make_train_step`` at ``case["lr"]`` (or, with ``program``, of
    ``StepEngine.for_lm`` under :func:`lm_program`), under a
    :class:`SplitSpy`; then one forward's block gathers beside their
    reckoning."""
    from repro_torch import adapt
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding
    from repro_torch.dist.plan import use_plan
    from repro_torch.elastic.reshard import place
    from repro_torch.interop import params_from_jax
    from repro_torch.models import probes, ssm
    from repro_torch.models import transformer as tf
    from repro_torch.models.moe import MoE
    from repro_torch.optim import sgd
    from repro_torch.train import StepEngine, init_state, make_train_step

    plans, out = {}, {}
    for case in a["cases"]:
        shape = tuple(case["shape"])
        if shape not in plans:  # every rank builds the meshes in the same order
            plans[shape] = rung_plan(shape)
        plan = plans[shape]
        cfg = get_config(case["arch"], reduced=True).replace(**case.get("extra", {}))
        opt = sgd(momentum=0.9)
        state = init_state(place(params_from_jax(a[case["params"]], cfg), plan), opt)
        layout = sharding.layout_of(state.params)
        tier = case.get("tier", "moment")
        kw = {}
        if tier == "gram":
            kw = dict(probe_loss=lambda p, pr, b: probes.loss_with_probes(cfg, p, pr, b),
                      probe_specs=lambda p, n: probes.probe_specs(cfg, n, SEQ, device="cpu"))
        rec = {"loss": [], "sq_norm_sum": [], "batch": [], "diversity": [],
               "held": sum(p.numel() for p in state.params.parameters()),
               "reckoned": layout.numel()}
        tf.reset_tp_counts()
        with SplitSpy() as spy:
            if case.get("program"):
                eng = StepEngine.for_lm(cfg, opt, micro_batch=4, dp_size=plan.dp_size,
                                        plan=plan, attn_impl="pallas")
                program = lm_program(adapt)
                m = program.batch_size
                for step in range(6):
                    state, metrics = eng.step(state, tp_batch(cfg, case["seed"], step, m), 0.1)
                    rec["loss"].append(float(metrics["loss"]))
                    rec["batch"].append(m)
                    if step in (2, 5):
                        sig, state = adapt.read_signals(state, "moment", reset=True,
                                                        batch_size=m)
                        program.observe(sig, adapt.Clock(epoch=step // 3, step=step + 1,
                                                         boundary="tick"))
                        rec["diversity"].append(sig.diversity)
                        m = program.batch_size
                rec["buckets"] = list(eng.stats.buckets)
            else:
                step = make_train_step(cfg, opt, 2, plan=plan, estimator=tier,
                                       moe_groups=case.get("moe_groups", 1), **kw)
                for i in range(case.get("steps", 3)):
                    state, metrics = step(state, tp_batch(cfg, case["seed"], i, 8),
                                          case.get("lr", 0.1))
                    rec["loss"].append(float(metrics["loss"]))
                    rec["sq_norm_sum"].append(state.div_state.sq_norm_sum.item())
            rec["tp_counts"], rec["vp_counts"] = tf.tp_counts(), tf.vocab_parallel_counts()
            rec["vocab_gathers"] = list(spy.vocab_gathers)
            rec["cp_counts"] = tf.context_parallel_counts()
            rec["mamba_counts"] = ssm.collective_counts()
            spy.block_gather_bytes, spy.context_colls = 0, []
            batch = {k: torch.as_tensor(v) for k, v in tp_batch(cfg, 0, 0, 2).items()}
            moes = [m for m in state.params.modules() if isinstance(m, MoE)]
            for m in moes:
                m.stats = {}
            with torch.no_grad(), use_plan(plan):
                tf.loss_fn(cfg, state.params, batch)
            rec["moe_stats"] = [(int(m.stats["dropped"]), int(m.stats["first_top"]))
                                for m in moes]
            for m in moes:
                m.stats = None
        rec.update(heads=sorted(spy.heads), ffn=sorted(spy.ffn), moe=sorted(spy.moe),
                   rows=sorted(spy.rows), context_colls=list(spy.context_colls),
                   scan=sorted(spy.scan), mamba_weights=sorted(spy.mamba_weights),
                   leaves=sorted(spy.leaves), block_gather_bytes=spy.block_gather_bytes,
                   block_gather_reckoned=block_gather_reckoning(cfg, state.params),
                   params=_whole_numpy(state.params))
        out[case["name"]] = rec
    return out


def tp_grads(a: dict) -> dict:
    """Reduced qwen2-7b on ``a["shape"]`` (4 tp ranks: each KV head shared
    by two, the biases replicated): the gradients of one microbatch's loss,
    gathered whole, against the whole model's on this process, with the
    k/v and bias gradients summed over the model group, and again with the
    gather's slice-own rule (no sum: what ``_GatherShards`` did for every
    non-data axis before tensor-parallel compute).  Max relative errors by
    leaf kind."""
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding
    from repro_torch.dist.plan import use_plan
    from repro_torch.elastic.reshard import place
    from repro_torch.interop import params_from_jax
    from repro_torch.models import transformer as tf

    plan = rung_plan(tuple(a["shape"]))
    cfg = get_config("qwen2-7b", reduced=True)
    batch = {k: torch.as_tensor(v) for k, v in tp_batch(cfg, 3, 0, 2).items()}
    whole = params_from_jax(a["qwen2"], cfg).requires_grad_(True)
    names = [n for n, _ in whole.named_parameters()]
    want = dict(zip(names, torch.autograd.grad(tf.loss_fn(cfg, whole, batch)[0],
                                               list(whole.parameters()))))
    model = place(params_from_jax(a["qwen2"], cfg), plan).requires_grad_(True)
    layout = sharding.layout_of(model)

    def errors() -> dict:
        with use_plan(plan):
            grads = torch.autograd.grad(tf.loss_fn(cfg, model, batch)[0],
                                        list(model.parameters()))
        grads = layout.finish_grads(grads)
        err: dict = {}
        for n, g in zip(names, grads):
            kind = ("kv" if n.endswith(("attn.k.weight", "attn.v.weight")) else
                    "bias" if n.endswith("bias") else "other")
            g = layout.unshard(n, g)
            e = float((g - want[n]).abs().max() / want[n].abs().max())
            err[kind] = max(err.get(kind, 0.0), e)
        return err

    out = {"summed": errors(), "split": sharding.tp_split(cfg, 0, plan).attn}
    role = sharding.TpSplit.role
    sharding.TpSplit.role = lambda self, name: None if role(self, name) == "partial" \
        else role(self, name)
    try:
        out["slice_own"] = errors()
    finally:
        sharding.TpSplit.role = role
    return out


def tp_gradcheck(a: dict) -> dict:
    """``gradcheck`` in float64 of ``copy_to_group`` then a rank's own
    linear map then ``reduce_from_group`` over the model axis of each rung
    of ``a["shapes"]`` (the composite's Jacobian is the sum of the ranks'
    maps on every rank when each collective's backward is its adjoint);
    the same around the context-parallel exchanges and the Mamba mixer's
    two (``ssm.channel_rows``' exchange of ``in_proj``'s column shard,
    ``x_proj``'s sum over tp behind ``copy_to_group``); and whether the
    exchange yields the rank's ``[x_t | z_t]`` rows of the whole weight
    exactly ("... in_proj rows")."""
    from repro_torch.dist.plan import copy_to_group, gather_shards, reduce_from_group
    from repro_torch.dist.sharding import TensorParallel, tp_rank
    from repro_torch.models import ssm
    from repro_torch.models import transformer as tf

    out = {}
    for shape in a["shapes"]:
        plan = rung_plan(tuple(shape))
        mesh = plan.mesh
        t = mesh.shape["model"]
        tp = TensorParallel(mesh, ("model",), t, tp_rank(plan))
        r = np.random.default_rng(dist.get_rank())
        mine = torch.from_numpy(r.standard_normal((3, 4)))
        z = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 3))).requires_grad_(True)

        def fn(z):
            return reduce_from_group(copy_to_group(z, mesh, "model") @ mine, mesh, "model")

        # the context-parallel exchanges: (2, 2t, 3) rows through the rank's
        # columns, the q all-to-all and the out all-to-all, and the k/v
        # all-gather of the rank's columns with its summed backward
        cols = torch.from_numpy(r.standard_normal((3, 2)))
        scale = torch.from_numpy(r.standard_normal((2 * t, 2 * t)))
        zz = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 2 * t, 3))
                              ).requires_grad_(True)

        def exchange(z):
            x = copy_to_group(z, mesh, "model") @ cols  # (2, 2t, 2): this rank's columns
            rows = tf._cols_to_rows(x, tp)  # (2, 2, 2t): its rows, every column
            back = tf._rows_to_cols(rows * scale[:2], tp)
            return reduce_from_group(back * x, mesh, "model")

        def kv_gather(z):
            x = copy_to_group(z, mesh, "model") @ cols
            whole = gather_shards([x], [[(2, ("model",))]], mesh, (), summed=[True])[0]
            return reduce_from_group(whole * scale[:, :2 * t], mesh, "model")

        # the Mamba mixer's: in_proj (2 d_inner, d) whole on every rank, this
        # rank's column shard (rows [2 t c, 2 (t+1) c)) through the exchange,
        # then a map of its own; x_proj's partial sums over tp, summed again
        # in the backward, then each rank's channels read the whole
        c, d = 2, 3
        w_whole = torch.from_numpy(np.random.default_rng(2).standard_normal((2 * t * c, d))
                                   ).requires_grad_(True)
        rows_map = torch.from_numpy(r.standard_normal((2 * c, d)))
        shard = slice(2 * tp.rank * c, 2 * (tp.rank + 1) * c)

        def in_proj(w):
            mine = ssm.channel_rows(copy_to_group(w, mesh, "model")[shard], tp)
            return reduce_from_group((mine * rows_map).sum(0), mesh, "model")

        part = torch.from_numpy(r.standard_normal((3, 4)))
        reads = torch.from_numpy(r.standard_normal((4, 2)))

        def x_proj(z):
            whole = copy_to_group(reduce_from_group(copy_to_group(z, mesh, "model") @ part,
                                                    mesh, "model"), mesh, "model")
            return reduce_from_group(whole @ reads, mesh, "model")

        key = "x".join(map(str, shape))
        for name, f, arg in ((key, fn, z), (key + " all-to-all", exchange, zz),
                             (key + " k/v all-gather", kv_gather, zz),
                             (key + " in_proj exchange", in_proj, w_whole),
                             (key + " x_proj sum", x_proj, z)):
            out[name] = bool(torch.autograd.gradcheck(f, (arg,), eps=1e-6, atol=1e-8))
        w = w_whole.detach()
        t0 = tp.rank * c
        want = torch.cat([w[t0:t0 + c], w[t * c + t0:t * c + t0 + c]])
        out[key + " in_proj rows"] = bool(torch.equal(ssm.channel_rows(w[shard], tp), want))
    return out


def tp_xent(a: dict) -> dict:
    """``xent_vocab_parallel`` on each rung of ``a["shapes"]``, behind
    ``copy_to_group`` over the model axis, against ``xent_chunked`` on the
    whole head in float32 (B 2, S 8 in chunks of 4, V 64, d 16; targets
    on every shard's edges ``v0 - 1``, ``v0``, ``v0 + V_t - 1``), with and
    without the softcap: the loss's, dx's and the rank's dW rows' largest
    gaps relative to the whole's largest magnitude."""
    from repro_torch.dist import sharding
    from repro_torch.models import transformer as tf

    b, s, v, d = 2, 8, 64, 16
    out = {}
    for shape in a["shapes"]:
        plan = rung_plan(tuple(shape))
        t = shape[1]
        tp = sharding.TensorParallel(plan.mesh, ("model",), t, sharding.tp_rank(plan))
        vt = v // t
        r = np.random.default_rng(21)
        x0 = torch.from_numpy(r.standard_normal((b, s, d), dtype=np.float32))
        w0 = torch.from_numpy(r.standard_normal((v, d), dtype=np.float32))
        edges = sorted({e for k in range(t) for e in (k * vt - 1, k * vt, k * vt + vt - 1)
                        if 0 <= e < v})
        tgt = r.integers(0, v, size=b * s)
        tgt[:len(edges)] = edges
        targets = torch.from_numpy(tgt.reshape(b, s))
        for cap in (None, 30.0):
            x, w = x0.clone().requires_grad_(True), w0.clone().requires_grad_(True)
            want = tf.xent_chunked(x, w, targets, 4, cap)
            dx_w, dw_w = torch.autograd.grad(want, (x, w))
            x = x0.clone().requires_grad_(True)
            wt = w0[tp.rank * vt:(tp.rank + 1) * vt].clone().requires_grad_(True)
            got = tf.xent_vocab_parallel(tp.copy(x), wt, tp.rank * vt, targets, 4, cap, tp)
            dx, dwt = torch.autograd.grad(got, (x, wt))
            mine = dw_w[tp.rank * vt:(tp.rank + 1) * vt]
            out[("x".join(map(str, shape)), cap)] = {
                "loss": float((got - want).abs() / want.abs()),
                "dx": float((dx - dx_w).abs().max() / dx_w.abs().max()),
                "dw": float((dwt - mine).abs().max() / dw_w.abs().max()),
                "edges": len(edges)}
    return out


# ---------------------------------------------------------------------------
# tensor-parallel serving (tests/test_torch_serve_tp.py)
# ---------------------------------------------------------------------------


class _Attention:
    """A module of attention functions as ``models/transformer.py`` sees it
    while a :class:`ServeSpy` is active: the names ``spied`` record the
    heads ``(query, KV)`` of each call, then run the module's own (whose
    names stay theirs: a kernel wrapper counts its launches under its
    name)."""

    def __init__(self, module, spied, heads: set):
        self._module, self._spied, self._heads = module, spied, heads

    def __getattr__(self, name):
        fn = getattr(self._module, name)
        if name not in self._spied:
            return fn

        def call(q, k, *a, **kw):
            self._heads.add((q.shape[2], k.shape[-2]))
            return fn(q, k, *a, **kw)
        return call


class ServeSpy:
    """Records, while active, the head counts ``(query, KV)`` the serving
    attention calls see (the paged-decode and chunk wrappers, the plain
    ring decode), the dense FFNs' hidden widths and the experts' widths."""

    def __init__(self):
        self.heads, self.ffn, self.moe = set(), set(), set()

    def __enter__(self):
        from repro_torch.models import transformer as tf

        self.saved = (tf.kernels_attn, tf.attn_lib, tf.FFN.forward, tf.moe_apply)
        kattn, attn_lib, ffn_fwd, moe = self.saved

        def spy_ffn(mod, x):
            self.ffn.add((mod.w_up if mod.glu else mod.w_in).weight.shape[0])
            return ffn_fwd(mod, x)

        def spy_moe(params, x, **kw):
            self.moe.add(params.w_gate.shape[-1])
            return moe(params, x, **kw)

        tf.kernels_attn = _Attention(kattn, ("paged_decode_attention", "chunk_attention"),
                                     self.heads)
        tf.attn_lib = _Attention(attn_lib, ("decode_attention",), self.heads)
        tf.FFN.forward, tf.moe_apply = spy_ffn, spy_moe
        return self

    def __exit__(self, *exc):
        from repro_torch.models import transformer as tf

        tf.kernels_attn, tf.attn_lib, tf.FFN.forward, tf.moe_apply = self.saved


def _np(tree) -> dict:
    from repro_torch.ckpt.checkpoint import tree_flatten_with_paths

    return {p: t.detach().cpu().numpy().copy() for p, t in tree_flatten_with_paths(tree)}


def serve_recorded(eng, reqs, every: bool = False) -> dict:
    """:func:`serve_ramp` on ``eng``, recording each decode step's logits
    of the live rows (with the engine step and the slot rows ``[lo, hi)``
    this process decoded; free lanes read the sentinel block) and, after every step on which this process computes on the
    ladder's widest rung (every step off a ladder), a snapshot of the pool
    and the slot cache: the last (``snap``), or with ``every`` all of them
    by step (``snaps``)."""
    from repro_torch.models import transformer as tf

    rec = {"logits": [], "snap": None, "snaps": {}}
    inner_step, inner_decode = eng.step, tf.decode_step
    count = [0]

    def decode(*a, **kw):
        out = inner_decode(*a, **kw)
        lo, hi = eng._row_range(eng._bucket)
        live = np.asarray(eng.sched.slot_rids())[lo:hi] >= 0  # free lanes read garbage
        rec["logits"].append((count[0], (lo, hi), live, out[0].detach().cpu().numpy()))
        return out

    def step():
        more = inner_step()
        count[0] += 1
        on = eng._elastic is None or eng.rung.index == eng._elastic.full.index
        if on and eng._active and eng._cache:
            rec["snap"] = {"step": count[0], "rows": eng._row_range(eng._bucket),
                           "split": eng._splits(), "pool": _np(eng._pages),
                           "cache": _np(eng._cache)}
            if every:
                rec["snaps"][count[0]] = rec["snap"]
        return more

    eng.step, tf.decode_step = step, decode
    try:
        rec["tokens"], rec["rungs"] = serve_ramp(eng, reqs)
    finally:
        tf.decode_step = inner_decode
    rec["rungs"] = sorted(r for r in rec["rungs"] if r is not None)
    return rec


def _tp_entries(cfg, tree, plan, max_seq: int) -> dict:
    """``prefill_step`` (its dense cache), ``prefill_chunk`` (the pool and
    the rings) then paged ``decode_step`` on a module sharded on the tp
    ``plan`` and on the whole module: the logits' largest gap relative to
    their largest magnitude, and the largest gap of the caches this rank
    holds against the whole ones' heads ``[first, first + count)``,
    relative to each leaf's largest magnitude."""
    from repro_torch.dist import sharding
    from repro_torch.elastic.reshard import place
    from repro_torch.interop import params_from_jax
    from repro_torch.models import transformer as tf

    whole = params_from_jax(tree, cfg)
    shard = place(params_from_jax(tree, cfg), plan)
    attn = [p for p in range(cfg.period) if cfg.pattern[p] != "mamba"][0]
    first, count = sharding.serving_kv_heads(cfg, attn, plan)
    r = np.random.default_rng(17)
    toks = torch.from_numpy(r.integers(1, cfg.vocab_size, size=(2, 16)))
    chunk = torch.from_numpy(r.integers(1, cfg.vocab_size, size=(1, 16)))

    def serve(model):
        kv = tf.serving_kv_heads(cfg, plan if model is shard else None)
        logits, dense = tf.prefill_step(cfg, model, {"tokens": toks})
        ld, dense = tf.decode_step(cfg, model, dense, toks[:, -1:])
        pages = tf.init_pages(cfg, 8, 8, device="cpu", kv_heads=kv)
        row = tf.init_cache(cfg, 1, max_seq, skip=tf.paged_positions(cfg), device="cpu",
                            kv_heads=kv)
        row["len"] = torch.zeros((1,), dtype=torch.int32)
        lc, row, pages = tf.prefill_chunk(cfg, model, row, pages, {"tokens": chunk}, 0,
                                          torch.zeros((0,), dtype=torch.int64),
                                          torch.tensor([1, 2]))
        lp, row, pages = tf.decode_step(cfg, model, row, chunk[:, -1:], pages=pages,
                                        tables=torch.tensor([[1, 2, 3, 0]]))
        return [logits, ld, lc, lp], {"dense": _np(dense), "row": _np(row),
                                      "pages": _np(pages)}

    (lw, cw), (ls, cs) = serve(whole), serve(shard)
    gap = 0.0
    for tree_w, tree_s in ((cw[k], cs[k]) for k in cw):
        for path, w in tree_w.items():
            x = tree_s[path]
            if path.rsplit("/", 1)[-1] in ("k", "v"):
                w = w[..., first:first + count, :]
            if x.size:
                gap = max(gap, float(np.abs(x - w).max() / max(np.abs(w).max(), 1e-30)))
    rel = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(ls, lw))
    return {"logits_rel": rel, "cache_gap": gap, "heads": (first, count)}


def serve_tp(a: dict) -> dict:
    """Each case of ``a["cases"]`` served through :func:`serve_recorded` on
    its rank rung: ``case["shape"]`` ``(data, model)`` a fixed plan under
    ``use_plan``, or ``"ladder"``, ``MeshLadder(model_axes=(("model", 2),))``
    over the world's ranks; the model from the reference weights
    ``a["trees"][case["params"]]`` (``case["extra"]`` replaced in the
    config), under a :class:`ServeSpy`.  Per case the tokens, the logits and
    the snapshot, this rank's KV heads and tp coordinate, held and reckoned
    parameters, ``tp_counts``; with ``case["entries"]``, :func:`_tp_entries`.
    Then ``moe_impl="ep"`` on a tp rung, which must be refused."""
    from repro_torch.configs import get_config
    from repro_torch.dist import sharding
    from repro_torch.dist.plan import rank_devices, use_plan
    from repro_torch.elastic import MeshLadder
    from repro_torch.interop import params_from_jax
    from repro_torch.models import transformer as tf
    from repro_torch.serve import Request, ServeEngine

    kw = dict(max_slots=8, max_seq=a["max_seq"], prompt_granule=a["granule"], block_size=8,
              prefill_chunk=8)
    plans, out = {}, {}
    for case in a["cases"]:
        shape = case["shape"]
        if shape not in plans:  # every rank builds the meshes in the same order
            plans[shape] = (MeshLadder(rank_devices("cpu"), granule=1,
                                       model_axes=(("model", 2),)) if shape == "ladder"
                            else rung_plan(tuple(shape)))
        cfg = get_config(case["arch"], reduced=True).replace(**case.get("extra", {}))
        params = params_from_jax(a["trees"][case["params"]], cfg)
        reqs = [Request(prompt=p, max_new_tokens=m) for p, m in zip(a["prompts"], a["max_new"])]
        tf.reset_tp_counts()
        with ServeSpy() as spy:
            if shape == "ladder":
                eng = ServeEngine(cfg, params, elastic=plans[shape], **kw)
                widest = plans[shape].full.plan
            else:
                with use_plan(plans[shape]):
                    eng = ServeEngine(cfg, params, **kw)
                widest = plans[shape]
            rec = serve_recorded(eng, reqs)
        layout = sharding.layout_of(eng.params)
        attn = [p for p in range(cfg.period) if cfg.pattern[p] != "mamba"][0]
        rec.update(heads=sorted(spy.heads), ffn=sorted(spy.ffn), moe=sorted(spy.moe),
                   tp_counts=tf.tp_counts(), tp_rank=eng._tp_rank, kv_heads=eng._kv_heads,
                   first=sharding.serving_kv_heads(cfg, attn, widest)[0],
                   held=sum(p.numel() for p in eng.params.parameters()),
                   reckoned=layout.numel() if layout is not None else None,
                   reshards=eng.stats.reshards)
        if case.get("entries"):
            rec["entries"] = _tp_entries(cfg, a["trees"][case["params"]], widest,
                                         a["max_seq"])
        out[case["name"]] = rec
    cfg = get_config("dbrx-132b", reduced=True)
    try:
        with use_plan(rung_plan((1, dist.get_world_size()))):
            ServeEngine(cfg.replace(moe_impl="ep"), params_from_jax(a["trees"]["dbrx"], cfg),
                        **kw)
        out["ep_refused"] = ""
    except NotImplementedError as e:
        out["ep_refused"] = str(e)
    return out


def serve_tp_frontend(a: dict) -> dict:
    """Each case of ``a["frontend_cases"]``, an embedding-input config from
    the reference weights ``a["trees"][case["params"]]`` (``case["extra"]``
    replaced), on a ``(data 1, model W)`` plan over the world's ranks:
    ``prefill_step`` on ``a["frames"]`` then, for a causal config, lockstep
    ``decode_step`` on each of ``a["steps"]`` over its dense cache; the
    logits of each call and ``tp_counts``."""
    from repro_torch.configs import get_config
    from repro_torch.elastic.reshard import place
    from repro_torch.interop import params_from_jax
    from repro_torch.models import transformer as tf

    plan = rung_plan((1, dist.get_world_size()))
    out = {}
    for case in a["frontend_cases"]:
        cfg = get_config(case["arch"], reduced=True).replace(**case.get("extra", {}))
        model = place(params_from_jax(a["trees"][case["params"]], cfg), plan)
        tf.reset_tp_counts()
        out[case["name"]] = {"logits": frontend_serve(cfg, model, a["frames"], a["steps"]),
                             "tp_counts": tf.tp_counts()}
    return out


def frontend_serve(cfg, model, frames, steps) -> list:
    """``prefill_step`` on ``frames`` (B, S, d_model) then, for a causal
    config, lockstep ``decode_step`` on each of ``steps`` (B, 1, d_model)
    over its dense cache: each call's float32 logits (numpy)."""
    from repro_torch.models import transformer as tf

    logits, cache = tf.prefill_step(cfg, model, {"embeddings": torch.as_tensor(frames)})
    out = [logits.numpy()]
    if cfg.causal:
        for e in steps:
            logits, cache = tf.decode_step(cfg, model, cache, torch.as_tensor(e))
            out.append(logits.numpy())
    return out


def serve_tp_cli(a: dict) -> dict:
    """``launch.serve --device cpu --tp 2 --backend gloo`` on the ranks; on
    rank 0 also the one-process CLI on the same flags."""
    import contextlib
    import io

    from repro_torch.launch import serve as launch_serve

    flags = ["--device", "cpu", "--requests", "6", "--max-new", "6", "--prefill-chunk", "8",
             "--block-size", "8"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        got = launch_serve.main(flags + ["--tp", "2", "--backend", "gloo"])
    out = {"tokens": [r.tokens.tolist() for r in got["results"]], "out": buf.getvalue(),
           "kv_heads": got["engine"]._kv_heads}
    if dist.get_rank() == 0:
        with contextlib.redirect_stdout(io.StringIO()):
            one = launch_serve.main(flags)
        out["one"] = [r.tokens.tolist() for r in one["results"]]
    return out


JOBS = {"lm_moment": lm_moment, "lm_probe_tiers": lm_probe_tiers, "lm_moe": lm_moe,
        "pod": pod, "cli": cli, "pod_mean": pod_mean, "sharded_train": sharded_train,
        "sharded_collectives": sharded_collectives, "sharded_ckpt": sharded_ckpt,
        "sharded_restore": sharded_restore, "moe_ep": moe_ep,
        "sharded_rungs": sharded_rungs, "serve_ranks": serve_ranks, "serve_cli": serve_cli,
        "dryrun_collectives": dryrun_collectives, "tp_train": tp_train, "tp_grads": tp_grads,
        "tp_gradcheck": tp_gradcheck, "tp_xent": tp_xent, "serve_tp": serve_tp,
        "serve_tp_cli": serve_tp_cli, "serve_tp_frontend": serve_tp_frontend}


def start_ranks(tmp_path, job: str, args: dict, world: int):
    """Start ``job`` on ``world`` gloo ranks (spawned, meeting through a
    ``FileStore`` in ``tmp_path``) and return at once; :func:`collect`
    waits for them."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    store = str(tmp_path / f"store_{job}")
    procs = [ctx.Process(target=run, args=(r, world, store, job, args, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, queue


def spawn_ranks(tmp_path, job: str, args: dict, world: int, deadline_s: float = 240) -> dict:
    """Run ``job`` on ``world`` gloo ranks (spawned, meeting through a
    ``FileStore`` in ``tmp_path``); ``{rank: result}``.  Kills the ranks and
    fails past the deadline or on any rank's error."""
    return collect(start_ranks(tmp_path, job, args, world), deadline_s)


def collect(started, deadline_s: float = 240) -> dict:
    """``{rank: result}`` of :func:`start_ranks`' ranks; kills them and
    fails past the deadline or on any rank's error."""
    procs, queue = started
    try:
        results = dict(queue.get(timeout=deadline_s) for _ in procs)
        for p in procs:
            p.join(timeout=60)
            assert not p.is_alive(), "a rank did not exit"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    errors = {r: v for r, v in results.items() if isinstance(v, str)}
    assert not errors, "\n".join(f"rank {r}:\n{v}" for r, v in errors.items())
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return results
