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
  python -m repro_torch.launch.train_lm --arch hubert-xlarge --full-width 48 \\
      --seq-len 1024 --micro-batch 2 --m0 4 --m-max 4 --lr 0.02 --steps 3 \\
      --profile /tmp/hubert.json
  python -m repro_torch.launch.train_lm --arch falcon-mamba-7b --full-width 4 \\
      --seq-len 4096 --micro-batch 2 --m0 2 --m-max 4 --steps 4

The default model is the ~20M-parameter ``lm-20m`` (float32);
``--full-width N`` trains Yi-6B's widths (d_model 4096, 32/4 heads, d_ff
11008, vocab 64000) at N of its 32 layers, bf16 with per-layer remat, or
with ``--arch hubert-xlarge`` the encoder's (d_model 1280, 16 heads of hd
80, non-causal, d_ff 5120, vocab 504) at N of its 48 layers, on frame
batches from :func:`frame_batches`; any other ``--arch`` of the registry
(the dense and the MoE decoders, ``dbrx-132b`` and ``kimi-k2-1t-a32b``
routing each microbatch in one group; the Mamba archs, ``falcon-mamba-7b``
at any N and ``jamba-v0.1-52b`` at a multiple of its period of 8) likewise
at N of its layers.
Weights are random, from ``--seed``.
``--profile PATH`` runs the first step unprofiled (warm-up), then the rest
under ``torch.profiler``: a Chrome trace to PATH (write it outside the
repository), the ops by device time, and the device's busy and idle
share.  The device defaults to ``cuda`` and raises without a Hopper card.  ``--ckpt-dir`` saves ``{"state": state}``
with ``extra={"program": ...}`` at every tick, as the reference example
does, in the reference's format and paths (the layers stacked into
``pos{p}``, kernels ``(d_in, d_out)``); ``resume`` restores such a
checkpoint into a state, and ``train(start_step=...)`` continues from it.

``--dp N`` trains data-parallel over N ranks under ``torchrun`` on
``--backend`` (NCCL wants a card per rank; gloo lets several ranks share
one card, staging each all-reduce through the host): ``--micro-batch`` is
the global microbatch, each rank taking ``micro_batch / N`` of it.  Every
rank draws the same weights from ``--seed`` and keeps its shard of the
state (``elastic.reshard.place``: the reference's ``fsdp``/``ep`` rules over
the ``data`` axis, so a rank holds half the state on 2 ranks, the LM head
excepted, which shards over ``tp`` only); only rank 0 prints and profiles,
and rank 0 writes the checkpoints (each leaf gathered whole as it is
written).

  torchrun --nproc-per-node 2 -m repro_torch.launch.train_lm --dp 2 --backend gloo

``--tp N`` trains on a ``(data W/N, model N)`` rung of the torchrun world's
W ranks (``launch.mesh.make_production_mesh(tp=N)``, ``make_plan``): the
state sharded by the reference's rules, each block's attention heads and
FFN widths split over the N model ranks, the embedding's (or frontend's)
``d/N`` columns looked up on each rank and the cross-entropy
vocab-parallel where N divides the vocabulary (``models/transformer.py``;
no rank gathers the ``(V, d)`` table or head whole); ``--micro-batch`` is
the global microbatch, each data row taking
``micro_batch / (W/N)`` of it.  With ``--dp D`` too the world must be D·N.
Where N does not divide the heads but divides their widths and
``--seq-len``, attention runs context-parallel (each rank its
``seq_len/N`` query rows of every head): internvl2-1b's 14 heads at
``--tp 4``, say.  Rank 0 prints each block kind's split (``tp: attention
context, ffn dense``).

  torchrun --nproc-per-node 2 -m repro_torch.launch.train_lm --tp 2 --backend gloo
  torchrun --nproc-per-node 4 -m repro_torch.launch.train_lm --tp 4 --backend gloo \\
      --arch internvl2-1b --full-width 1 --seq-len 16 --micro-batch 4 --m0 4 --m-max 4
"""

from __future__ import annotations

import argparse
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import DEFAULT_DEVICE, interop, resolve_device
from repro_torch.adapt import (
    AdaptationProgram,
    Clock,
    DiveBatchPolicy,
    GradNoisePolicy,
    read_signals,
)
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.data import TokenStream
from repro_torch.dist import sharding
from repro_torch.elastic.reshard import place
from repro_torch.launch.mesh import data_plan, join_world, make_plan, make_production_mesh
from repro_torch.models import transformer as tf
from repro_torch.optim import sgd
from repro_torch.train import StepEngine, TrainState, init_state
from repro_torch.utils import pytree as ptu


def model_config(full_width: int | None = None, arch: str = "yi-6b") -> ModelConfig:
    """``lm-20m`` (the reference example's default), or ``arch``'s widths
    (Yi-6B's unless named) at ``full_width`` layers."""
    if full_width:
        return get_config(arch).replace(num_layers=int(full_width))
    return ModelConfig(
        name="lm-20m", family="dense", num_layers=6, d_model=384,
        num_heads=6, num_kv_heads=2, d_ff=1024, vocab_size=8_000,
        param_dtype="float32", compute_dtype="float32", xent_chunk=128,
        remat=False,
    )


def frame_batches(cfg: ModelConfig, seed: int = 0) -> Callable[[int, int, int], dict]:
    """The batch source of an embedding-input config (hubert-xlarge's frames):
    ``(step, batch, seq) -> {"embeddings", "targets"}``, embeddings N(0, 1)
    float32 (batch, seq, d_model) and targets uniform in ``[0, vocab)``
    int32, from ``numpy.random.default_rng((seed, step))``."""

    def batch(step: int, m: int, s: int) -> dict:
        r = np.random.default_rng((seed, step))
        return {"embeddings": r.standard_normal((m, s, cfg.d_model), dtype=np.float32),
                "targets": r.integers(0, cfg.vocab_size, size=(m, s)).astype(np.int32)}

    return batch


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


def resume(mgr: CheckpointManager, state: TrainState, program: AdaptationProgram,
           step: int | None = None) -> tuple[TrainState, int]:
    """Restore checkpoint ``step`` (the latest when None) of a ``--ckpt-dir``
    run into ``state`` (in place, on its device) and ``program``; returns
    ``(state, step)``: ``train(..., state=state, start_step=step)`` takes
    the run on from there."""
    out, extra = mgr.restore({"state": interop.reference_state(state, target=True)}, step)
    ref = out["state"]
    state = interop.load_reference_state(state, params=ref.params, opt_state=ref.opt_state,
                                         div_state=ref.div_state, step=int(ref.step))
    program.load_state_dict(extra["program"])
    return state, int(extra["step"])


def train(cfg: ModelConfig, params: tf.Transformer, program: AdaptationProgram, *,
          steps: int, seq_len: int, micro_batch: int, attn_impl: str = "pallas",
          data_seed: int = 0, log=print, engine: StepEngine | None = None,
          estimator: str = "moment", ckpt: CheckpointManager | None = None,
          state: TrainState | None = None, start_step: int = 0,
          batches: Callable[[int, int, int], dict] | None = None,
          plan=None, moe_groups: int = 1) -> dict:
    """Train ``params`` in place up to optimizer step ``steps``.

    ``batches(step, batch, seq_len)`` gives step ``step``'s global batch as
    a dict of arrays (numpy or tensors; ``{"tokens", "targets"}``, or
    ``{"embeddings", "targets"}`` for an embedding-input config); it
    defaults to ``TokenStream(cfg.vocab_size, seed=data_seed).batch``.

    Each step's loss is read back (so a step's wall time covers its device
    work); at every tick the signals are read with ``estimator``, the
    accumulators reset and the program decides the next batch.  ``engine``
    defaults to ``StepEngine.for_lm`` (the moment tier); a prebuilt one (the
    gram tier's, say) must have been built with ``sgd(momentum=0.9)`` and
    ``micro_batch``.  With ``ckpt`` the state and program are saved at every
    tick, at step + 1 (a record then holds ``ckpt_copy_s`` and
    ``ckpt_write_s``: the device -> host copy and the file writes).  A
    resumed run passes the restored ``state`` (holding ``params``) and
    ``start_step``: the batches are the stream's from that step on.  Returns
    ``{"records": [per-step dicts], "engine": StepEngine, "state":
    TrainState}``; a record holds ``step, batch, num_micro, loss, seconds``,
    for a MoE model ``ce_loss`` and ``moe_aux`` (the default engine routes
    each global microbatch in ``moe_groups`` groups) and, at ticks,
    ``diversity, gns, next_batch``.  Under a rank ``plan``
    every rank calls this with the same arguments and batch stream: the
    engine steps its share and averages the gradients over the plan's dp
    group, the checkpoints are the first rank's."""
    dev = next(params.parameters()).device
    opt = sgd(momentum=0.9)
    if state is None:
        state = init_state(params, opt)
    if batches is None:
        batches = TokenStream(cfg.vocab_size, seed=data_seed).batch
    if engine is None:
        engine = StepEngine.for_lm(cfg, opt, micro_batch=micro_batch, attn_impl=attn_impl,
                                   dp_size=plan.dp_size if plan is not None else 1,
                                   moe_groups=moe_groups, plan=plan)
    group = plan.mesh.group(plan.dp) if plan is not None and plan.mesh.ranked else None
    m = program.batch_size
    records = []
    for step in range(start_step, steps):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in batches(step, m, seq_len).items()}
        t0 = time.perf_counter()
        state, metrics = engine.step(state, batch, program.lr)
        loss = float(metrics["loss"])
        rec = {"step": step + 1, "batch": m, "num_micro": m // micro_batch, "loss": loss,
               "seconds": time.perf_counter() - t0}
        if cfg.num_experts and "moe_aux" in metrics:
            rec.update(ce_loss=float(metrics["ce_loss"]), moe_aux=float(metrics["moe_aux"]))
        if (step + 1) % program.tick_every == 0:
            sig, state = read_signals(state, estimator, reset=True, batch_size=m, loss=loss)
            program.observe(sig, Clock(epoch=step // program.tick_every, step=step + 1,
                                       boundary="tick"))
            rec.update(diversity=sig.diversity, gns=sig.gns, next_batch=program.batch_size)
            log(f"step {step + 1:4d} loss={loss:.4f} dt={rec['seconds']:.2f}s "
                f"Delta={sig.diversity:.4f} gns={sig.gns:.1f} -> batch {m} -> "
                f"{program.batch_size}")
            m = program.batch_size
            if ckpt is not None:
                # a sharded state's leaves are gathered on every rank as formed
                first = group is None or dist.get_rank() == plan.mesh.root
                mine = first or sharding.layout_of(state.params) is not None
                ckpt.save(step + 1,
                          {"state": interop.reference_state(state)} if mine else None,
                          extra={"program": program.state_dict()}, group=group,
                          root=plan.mesh.root if group is not None else None)
                rec.update(ckpt_copy_s=ckpt.last_copy_s, ckpt_write_s=ckpt.last_write_s)
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
                    help="--arch's widths at N layers (bf16, remat)")
    ap.add_argument("--arch", default="yi-6b", choices=list(ARCH_NAMES),
                    help="the architecture --full-width trains")
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
    ap.add_argument("--dp", type=int, default=0,
                    help="data-parallel ranks (under torchrun, a world of N)")
    ap.add_argument("--tp", type=int, default=0,
                    help="tensor-parallel ranks: a (data W/N, model N) rung of the "
                         "torchrun world's W ranks")
    ap.add_argument("--backend", default="nccl", choices=["nccl", "gloo"],
                    help="the process group's backend with --dp or --tp")
    ap.add_argument("--profile", default=None, metavar="PATH",
                    help="profile the steps after the first with torch.profiler: a "
                         "Chrome trace to PATH, the ops by device time, the busy share")
    args = ap.parse_args(argv)
    plan = None
    if args.tp:
        dev = join_world(args.backend, ranks=args.dp * args.tp if args.dp else None,
                         device=args.device, command="repro_torch.launch.train_lm")
        plan = make_plan(make_production_mesh(device=dev, tp=args.tp))
    elif args.dp:
        dev = join_world(args.backend, ranks=args.dp, device=args.device,
                         command="repro_torch.launch.train_lm")
        plan = data_plan(dev)
    else:
        dev = resolve_device(args.device)
    first = plan is None or dist.get_rank() == plan.mesh.root
    log = print if first else (lambda line: None)
    cfg = model_config(args.full_width, args.arch)
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed), dev)
    n_params = ptu.tree_count(params)
    if plan is not None:  # every rank draws the same weights and keeps its shard
        params = place(params, plan)
    log(f"model: {cfg.name} x {cfg.num_layers} layers, {n_params / 1e6:.1f}M params "
        f"on {dev}" + (f", rank {dist.get_rank()} of {dist.get_world_size()} "
                       f"{dict(plan.mesh.shape)} ({args.backend})"
                       if plan is not None else ""))
    if args.tp:
        splits = {sharding.tp_split(cfg, p, plan, args.seq_len) for p in range(cfg.period)}
        log("tp: " + "; ".join(f"attention {s.attn or 'whole'}, ffn {s.ffn or 'whole'}"
                               for s in sorted(splits, key=repr)))
    program = make_program(args.method, m0=args.m0, m_max=args.m_max, delta=args.delta,
                           granule=args.micro_batch, lr=args.lr,
                           tick_every=args.epoch_steps)
    kw = dict(seq_len=args.seq_len, micro_batch=args.micro_batch, attn_impl=args.attn_impl,
              data_seed=args.seed,
              batches=frame_batches(cfg, args.seed) if cfg.input_mode == "embeddings" else None,
              ckpt=CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None,
              plan=plan, log=log)
    if not args.profile or not first:
        return train(cfg, params, program, steps=args.steps, **kw)
    from torch.profiler import ProfilerActivity, profile

    on_card = dev.type == "cuda"
    warm = train(cfg, params, program, steps=1, **kw)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = train(cfg, params, program, steps=args.steps, state=warm["state"],
                    start_step=1, engine=warm["engine"], **kw)
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(args.profile)
    key = "self_device_time_total" if on_card else "self_cpu_time_total"
    print(prof.key_averages().table(sort_by=key, row_limit=25))
    if on_card:
        # device kernels only: an op's self device time repeats its kernels'
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
        print(f"profile: steps 2-{args.steps}: device busy {busy:.4f} s of {wall:.4f} s "
              f"wall (idle share {1 - busy / wall:.3f}, profiler on)")
    return out


if __name__ == "__main__":
    main()
