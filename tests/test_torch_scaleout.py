"""Scale-out over process groups: the port on 2 gloo ranks on the CPU,
against the reference and against its own one-process run.

Each spawn starts 2 ranks (``torch.multiprocessing``'s spawn context,
``tests/_scaleout_ranks.py``) that meet through a ``FileStore`` in
``tmp_path`` (no fixed port: xdist runs several workers), run with one
thread each and several jobs per spawn; a join past its deadline kills the
ranks and fails.  The reference (JAX) runs in this process only.

  * ``StepEngine.for_lm(dp_size=2)`` on ranks (moment tier, under a
    DiveBatch program) and ``make_train_step(dp_size=2)`` on the exact and
    gram tiers, against the reference's single-device ``make_train_step(
    dp_size=2)`` (its multi-device lanes fail on this box): the same batch
    schedule and buckets, losses within 1e-5 relative, ``sq_norm_sum``
    within 1e-5, parameters within 1e-5 relative plus 5e-5 of each tensor's
    RMS (the one-process parity bound of ``test_torch_train.py``); the
    replicas equal at every step (a float64 checksum per rank);
  * the ``Trainer`` on a ``PodLadder(pods=2)`` whose pods are the ranks
    (4 virtual devices each) through ``run_supervised(lose_pod=...)``,
    against the same run on one process (``["cpu"] * 8``): the schedule,
    losses, Delta, every cross-pod step's scales, every quantised code and
    the parameters to the bit, the demotion 3 -> 2 included, and the lost
    pod's rank leaving cleanly;
  * ``compressed_pod_mean`` over the pod group against the one-process
    exchange, to the bit;
  * ``launch/train.py --dp 2`` and ``--elastic`` against the reference's
    unsharded CLI: the same schedule, losses within 1e-5 relative;
  * ``run_supervised(fail_at=...)`` against the reference's, on one process.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

sys.path.insert(0, os.path.dirname(__file__))

import _scaleout_ranks as ranks  # noqa: E402
from repro import adapt as jadapt  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.data import TokenStream as JTokenStream  # noqa: E402
from repro.models import probes as jprobes  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro.train import StepEngine as JStepEngine  # noqa: E402
from repro.train import init_state as jinit_state  # noqa: E402
from repro.train import make_train_step as jmake_train_step  # noqa: E402

pytestmark = pytest.mark.slow

torch.set_num_threads(2)

WORLD = 2
DEADLINE_S = 240


def spawn(tmp_path, job: str, args: dict) -> dict:
    """Run ``job`` on ``WORLD`` gloo ranks; ``{rank: result}``.  Kills the
    ranks and fails past the deadline or on any rank's error."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    store = str(tmp_path / f"store_{job}")
    procs = [ctx.Process(target=ranks.run, args=(r, WORLD, store, job, args, queue))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        results = dict(queue.get(timeout=DEADLINE_S) for _ in procs)
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


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _tree_close(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        b = np.asarray(b)
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=5e-5 * np.sqrt(np.mean(b ** 2)))


# ---------------------------------------------------------------------------
# the LM step: the reference's dp_size=2 on one device
# ---------------------------------------------------------------------------


def _reference_moment(jparams):
    jcfg = jget("yi-6b", reduced=True)
    eng = JStepEngine.for_lm(jcfg, jsgd(momentum=0.9), micro_batch=4, dp_size=2,
                             attn_impl="pallas")
    state, program = jinit_state(jparams, jsgd(momentum=0.9)), ranks.lm_program(jadapt)
    stream = JTokenStream(jcfg.vocab_size, seed=1)
    out = {"loss": [], "batch": [], "diversity": []}
    m = program.batch_size
    for step in range(6):
        b = {k: jax.numpy.asarray(v) for k, v in stream.batch(step, m, ranks.SEQ).items()}
        state, metrics = eng.step(state, b, 0.1)
        out["loss"].append(float(metrics["loss"]))
        out["batch"].append(m)
        if step in (2, 5):
            sig, state = jadapt.read_signals(state, "moment", reset=True, batch_size=m)
            program.observe(sig, jadapt.Clock(epoch=step // 3, step=step + 1,
                                              boundary="tick"))
            out["diversity"].append(sig.diversity)
            m = program.batch_size
    out["buckets"] = list(eng.stats.buckets)
    out["params"] = _np_tree(state.params)
    return out


def _reference_probe_tier(jparams, tier):
    jcfg = jget("yi-6b", reduced=True).replace(scan_layers=False)
    hooks = dict(probe_loss=lambda p, pr, b: jprobes.loss_with_probes(jcfg, p, pr, b),
                 probe_specs=lambda p, n: jprobes.probe_specs(jcfg, n, ranks.SEQ))
    kw = {"psn_impl": "kernel"} if tier == "exact" else {}
    step = jax.jit(jmake_train_step(jcfg, jsgd(), 2, dp_size=2, estimator=tier,
                                    psn_interpret=True, **kw, **hooks))
    state = jinit_state(jparams, jsgd())
    stream = JTokenStream(jcfg.vocab_size, seed=3)
    out = {"loss": [], "sq_norm_sum": []}
    for i in range(3):
        b = {k: jax.numpy.asarray(v) for k, v in stream.batch(i, 8, ranks.SEQ).items()}
        state, metrics = step(state, b, jax.numpy.float32(0.1))
        out["loss"].append(float(metrics["loss"]))
        out["sq_norm_sum"].append(float(state.div_state.sq_norm_sum))
    out["params"] = _np_tree(state.params)
    return out


@pytest.fixture(scope="module")
def lm_runs(tmp_path_factory):
    jcfg = jget("yi-6b", reduced=True)
    moment_params = jtf.init_params(jcfg, jax.random.key(2))
    probe_params = jtf.init_params(jcfg.replace(scan_layers=False), jax.random.key(5))
    got = spawn(tmp_path_factory.mktemp("lm"), "lm_moment+lm_probe_tiers",
                {"lm_params": _np_tree(moment_params),
                 "probe_params": _np_tree(probe_params)})
    want = {"moment": _reference_moment(moment_params),
            **{t: _reference_probe_tier(probe_params, t) for t in ("exact", "gram")}}
    return got, want


def _ranks_of(got, tier):
    return [got[r]["lm_moment"] if tier == "moment" else got[r]["lm_probe_tiers"][tier]
            for r in range(WORLD)]


@pytest.mark.parametrize("tier", ["moment", "exact", "gram"])
def test_lm_dp_on_ranks_matches_reference(lm_runs, tier):
    """Losses within 1e-5 relative, parameters within the one-process bound,
    replicas equal at every step; the moment tier also its schedule,
    buckets and Delta at the ticks, the per-sample tiers ``sq_norm_sum``."""
    got, want = lm_runs
    per_rank = _ranks_of(got, tier)
    w = want[tier]
    for g in per_rank:
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
        _tree_close(g["params"], w["params"])
    assert per_rank[0]["checksum"] == per_rank[1]["checksum"]
    if tier == "moment":
        assert [g["batch"] for g in per_rank] == [w["batch"]] * WORLD
        assert len(set(w["batch"])) > 1  # the program resized the batch
        assert [g["buckets"] for g in per_rank] == [w["buckets"]] * WORLD
        for g in per_rank:
            np.testing.assert_allclose(g["diversity"], w["diversity"], rtol=1e-4)
    else:
        for g in per_rank:
            np.testing.assert_allclose(g["sq_norm_sum"], w["sq_norm_sum"], rtol=1e-5)


# ---------------------------------------------------------------------------
# the pod Trainer, the CLI: one spawn
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trainer_runs(tmp_path_factory):
    from repro.launch import train as jtrain_cli

    tmp = tmp_path_factory.mktemp("trainer")
    weights = _np_tree(jtrain_cli.build_task("synthetic-convex", 0)[1])
    got = spawn(tmp, "pod_mean+pod+cli", {"pod_ckpt": str(tmp / "pod_ranks"), "cli_weights": weights})
    # the one-process virtual run of the pod cell
    virtual = ranks.pod_run(["cpu"] * 8, str(tmp / "pod_virtual"))
    # the reference's unsharded CLI
    argv = sys.argv
    try:
        sys.argv = ["train", "--task", "synthetic-convex", "--epochs", "2",
                    "--out", str(tmp / "ref.json")]
        jtrain_cli.main()
    finally:
        sys.argv = argv
    with open(tmp / "ref.json") as f:
        ref = json.load(f)["history"]
    return got, virtual, ref


def test_pod_ranks_equal_the_virtual_run_to_the_bit(trainer_runs):
    got, virtual, _ = trainer_runs
    first, lost = got[0]["pod"], got[1]["pod"]
    # the schedule (batch, steps), losses and Delta per epoch, to the bit
    assert first["epochs"] == virtual["epochs"]
    batches = [e[0] for e in virtual["epochs"]]
    assert batches[0] == 128 and len(virtual["epochs"]) == ranks.POD_EPOCHS
    assert first["rungs"] == virtual["rungs"]
    assert 3 in virtual["rungs"] and virtual["final_rung"] == first["final_rung"] == 2
    # every cross-pod exchange's scales, and each pod's codes, to the bit
    assert len(first["scales"]) == len(virtual["scales"]) > 0
    for a, b in zip(first["scales"], virtual["scales"]):
        np.testing.assert_array_equal(a, b)
    n_leaves = len(virtual["params"])
    codes = np.array(virtual["codes"]).reshape(-1, 2, n_leaves)
    for rank in range(WORLD):
        np.testing.assert_array_equal(
            np.array(got[rank]["pod"]["codes"]).reshape(-1, n_leaves), codes[:, rank])
    for a, b in zip(first["params"], virtual["params"]):
        np.testing.assert_array_equal(a, b)
    # pod 1's rank left at the loss with the epochs before it
    assert lost["epochs"] == virtual["epochs"][:ranks.POD_LOST_AT]


def test_compressed_pod_mean_over_the_pod_group(trainer_runs):
    """``compressed_pod_mean(group=...)`` with one pod a rank: the mean on
    every rank, and each rank's residuals, are the one-process exchange's
    to the bit."""
    from repro_torch.dist.compression import compressed_pod_mean

    got = trainer_runs[0]
    trees = [ranks.pod_mean_trees(r) for r in range(WORLD)]
    mean, new_err = compressed_pod_mean([g for g, _ in trees], [e for _, e in trees])
    for rank in range(WORLD):
        for a, b in zip(got[rank]["pod_mean"]["mean"], mean):
            np.testing.assert_array_equal(a, b.numpy())
        for a, b in zip(got[rank]["pod_mean"]["err"], new_err[rank]):
            np.testing.assert_array_equal(a, b.numpy())


def _assert_cli(epochs, ref):
    assert [(e[0], e[1]) for e in epochs] == [(h["batch_size"], h["steps"]) for h in ref]
    np.testing.assert_allclose([[e[2], e[3]] for e in epochs],
                               [[h["train_loss"], h["val_loss"]] for h in ref], rtol=1e-5)


@pytest.mark.parametrize("mode", ["dp", "elastic"])
def test_cli_on_ranks_matches_reference(trainer_runs, mode):
    got, _, ref = trainer_runs
    for rank in range(WORLD):
        _assert_cli(got[rank]["cli"][mode]["epochs"], ref)
    assert got[0]["cli"][mode]["checksum"] == got[1]["cli"][mode]["checksum"]


# ---------------------------------------------------------------------------
# run_supervised on one process, against the reference's
# ---------------------------------------------------------------------------


def test_run_supervised_with_failures_matches_reference(tmp_path):
    """Six epochs of the supervisor's logistic task with failures injected
    at epochs 2 and 4 (a restart and resume each): the same schedule, losses
    within 1e-5 relative."""
    from repro.adapt import AdaptationProgram as JProgram
    from repro.adapt import DiveBatchPolicy as JDiveBatch
    from repro.data import sigmoid_synthetic as jsynthetic
    from repro.launch.supervisor import run_supervised as jrun_supervised
    from repro.models import small as jsmall
    from repro.train.loop import ModelFns as JFns
    from repro.train.loop import Trainer as JTrainer
    from repro_torch import interop
    from repro_torch.adapt import AdaptationProgram, DiveBatchPolicy
    from repro_torch.data import sigmoid_synthetic
    from repro_torch.launch.supervisor import run_supervised
    from repro_torch.models import small
    from repro_torch.optim import sgd
    from repro_torch.train.loop import ModelFns, Trainer

    jtrain, jval, _ = jsynthetic(n=4000, d=64, seed=0)
    train, val, _ = sigmoid_synthetic(n=4000, d=64, seed=0)
    weights = _np_tree(jsmall.logreg_init(jax.random.key(0), 64))

    def jmake(mgr):
        fns = JFns(batch_loss=jsmall.logreg_batch_loss, example_loss=jsmall.logreg_loss)
        program = JProgram(JDiveBatch(64, 1024, delta=0.1, dataset_size=len(jtrain),
                                      granule=16), base_lr=1.0, estimator="exact")
        # a fresh copy each start: the reference's step donates its buffers
        return JTrainer(fns, jax.tree.map(jax.numpy.asarray, weights), jsgd(momentum=0.9),
                        program, jtrain, jval,
                        estimator="exact", ckpt=mgr)

    def make(mgr):
        fns = ModelFns(batch_loss=small.logreg_batch_loss, example_loss=small.logreg_loss)
        program = AdaptationProgram(DiveBatchPolicy(64, 1024, delta=0.1,
                                                    dataset_size=len(train), granule=16),
                                    base_lr=1.0, estimator="exact")
        return Trainer(fns, interop.small_params_from_jax(weights),
                       sgd(momentum=0.9), program, train, val, estimator="exact",
                       ckpt=mgr)

    want = jrun_supervised(jmake, 6, [2, 4], str(tmp_path / "ref"))
    got = run_supervised(make, 6, [2, 4], str(tmp_path / "port"))
    assert [(h.epoch, h.batch_size, h.steps) for h in got] == \
        [(h.epoch, h.batch_size, h.steps) for h in want]
    assert len({h.batch_size for h in got}) > 1
    np.testing.assert_allclose([[h.train_loss, h.val_loss] for h in got],
                               [[h.train_loss, h.val_loss] for h in want], rtol=1e-5)
