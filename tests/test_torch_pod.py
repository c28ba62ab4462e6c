"""The port's pod slice against the JAX reference, on the CPU: virtual pod
topology, health, ``PodLadder``'s rungs and residual threading, the
cross-pod step, and the paper's ``Trainer`` on a two-pod ladder.

The reference runs on the 8 host devices of the test harness; the port on
``["cpu"] * 8``, eight virtual devices of one physical device.  Inputs come
from numpy with a seed, parameters from the reference init through
``interop.small_params_from_jax``.

Tolerances.  Quantisation is discontinuous: the reference's step runs under
``jit``, where XLA computes the scale ``absmax / 127`` as a product with
float32(1/127) (one ulp off the port's division in a few percent of
leaves), and the two packages sum gradients in different orders, so a code
can land on the neighbouring value and move that element of the mean by a
quantum.  The tests count such flipped codes (a residual that differs by
more than half a quantum; the quantum of a pod's leaf is its scale, from
the port step's ``scales`` metric) and bound them.  Away from flips,
float32 bounds hold: the cross-pod step's losses and ``div_state`` within
1e-5 relative, parameters and the mean gradient within 1e-5 absolute,
residuals within 1e-3 of a quantum.  The whole-slice Trainer: rungs, batch
schedules and the discrete ``EpochRecord`` fields equal, losses,
accuracies and diversity within 1e-4 relative, parameters within 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.adapt import AdaptationProgram as JProgram
from repro.adapt import FixedPolicy as JFixed
from repro.core import make_policy as jmake_policy
from repro.core.controller import AdaptiveBatchController as JController
from repro.data import sigmoid_synthetic
from repro.elastic import MeshLadder as JMeshLadder
from repro.models import small as jsmall
from repro.optim import sgd as jsgd
from repro.pod import PodHealth as JHealth
from repro.pod import PodLadder as JPodLadder
from repro.pod import step as jpod_step
from repro.train import init_state as jinit_state
from repro.train.loop import ModelFns as JFns
from repro.train.loop import Trainer as JTrainer
from repro_torch import data as tdata
from repro_torch.adapt import AdaptationProgram, FixedPolicy
from repro_torch.core.batch_policy import make_policy
from repro_torch.core.controller import AdaptiveBatchController
from repro_torch.elastic import MeshLadder, place, reshard, same_plan
from repro_torch.interop import small_params_from_jax, small_params_to_numpy
from repro_torch.models import small
from repro_torch.optim import sgd
from repro_torch.pod import PodHealth, PodLadder, PodTopology, make_pod_train_step
from repro_torch.train import init_state
from repro_torch.train.loop import ModelFns, Trainer

torch.set_num_threads(2)

SEED, N, D = 3, 2048, 32
CPU8 = ["cpu"] * 8


def _jfns():
    return JFns(batch_loss=jsmall.mlp_batch_loss, example_loss=jsmall.mlp_loss,
                metrics=lambda p, b: {"acc": jsmall.mlp_accuracy(p, b)})


def _fns():
    return ModelFns(batch_loss=small.mlp_batch_loss, example_loss=small.mlp_loss,
                    metrics=lambda p, b: {"acc": small.mlp_accuracy(p, b)})


def _params(seed=SEED, d=D):
    """(reference tree as numpy, the port's MLP with the same weights)."""
    tree = jax.tree.map(np.asarray, jsmall.mlp_init(jax.random.key(seed), d))
    return tree, small_params_from_jax(tree)


# ---------------------------------------------------------------------------
# PodTopology / PodHealth
# ---------------------------------------------------------------------------


def test_topology_partitions_contiguous_prefix_pods():
    topo = PodTopology(2, CPU8)
    assert len(topo) == topo.num_pods == 2 and topo.devices_per_pod == 4
    assert topo.pods[0] == CPU8[:4] and topo.pods[1] == CPU8[4:]
    assert topo.pod_of(0) == 0 and topo.pod_of(5) == 1
    with pytest.raises(ValueError, match="partition"):
        PodTopology(3, CPU8)
    with pytest.raises(ValueError, match=">= 1"):
        PodTopology(0, CPU8)
    with pytest.raises(ValueError, match="partition"):
        PodTopology(16, CPU8)
    with pytest.raises(ValueError, match="not in this topology"):
        PodTopology(2, CPU8[:4]).pod_of(7)


def test_health_matches_reference():
    ours, ref = PodHealth(4), JHealth(4)
    for op, pod in (("mark_lost", 2), ("mark_healthy", 2), ("mark_lost", 0),
                    ("mark_lost", 3), ("mark_healthy", 0)):
        getattr(ours, op)(pod)
        getattr(ref, op)(pod)
        assert ours.healthy_prefix == ref.healthy_prefix and ours.lost == ref.lost
        assert [ours.prefix_healthy(k) for k in range(6)] == \
            [ref.prefix_healthy(k) for k in range(6)]
        assert repr(ours) == repr(ref)
    with pytest.raises(ValueError, match="out of range"):
        PodHealth(2).mark_lost(2)
    with pytest.raises(ValueError, match=">= 1"):
        PodHealth(0)


# ---------------------------------------------------------------------------
# PodLadder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pods", [2, 4])
def test_rung_structure_matches_reference(pods):
    ours, ref = PodLadder(pods=pods, devices=CPU8, granule=16), JPodLadder(pods=pods,
                                                                            granule=16)
    assert ours.widths == ref.widths
    assert [r.pods for r in ours.rungs] == [r.pods for r in ref.rungs]
    for a, b in zip(ours.rungs, ref.rungs):
        assert a.index == b.index and a.dp == b.dp and a.devices == b.devices
        assert a.plan.dp == tuple(b.plan.dp) and a.plan.fsdp == tuple(b.plan.fsdp)
        assert a.plan.mesh.shape == dict(b.plan.mesh.shape)
    cross = ours.rungs[-1]
    assert cross.plan.dp == ("pod", "data") and cross.plan.fsdp == ()
    # every rung's devices are a prefix of the next rung's
    for narrow, wide in zip(ours.rungs, ours.rungs[1:]):
        assert wide.plan.mesh.flat()[: narrow.devices] == narrow.plan.mesh.flat()
    with pytest.raises(ValueError, match="pods >= 2"):
        PodLadder(pods=1, devices=CPU8)


def test_rung_for_batch_under_health_matches_reference():
    ours, ref = PodLadder(pods=2, devices=CPU8, granule=16), JPodLadder(pods=2, granule=16)
    for lost in ([], [1], []):
        for pod in lost:
            ours.health.mark_lost(pod)
            ref.health.mark_lost(pod)
        for m in (8, 16, 32, 64, 96, 128, 256, 1024):
            assert ours.rung_for_batch(m).index == ref.rung_for_batch(m).index, (lost, m)
        for pod in lost:
            ours.health.mark_healthy(pod)
            ref.health.mark_healthy(pod)
    assert ours.rung_for_batch(128).index == 3 and ours.rung_for_batch(64).index == 2
    ours.health.mark_lost(0)
    with pytest.raises(RuntimeError, match="pod 0"):
        ours.rung_for_batch(128)


@pytest.mark.parametrize("kw", [dict(granule=1), dict(granule=16),
                                dict(granule=4, dp_widths=[1, 3, 6])])
def test_mesh_ladder_matches_reference(kw):
    devs = CPU8[:6] if "dp_widths" in kw else CPU8
    ours, ref = MeshLadder(devs, **kw), JMeshLadder(jax.devices()[:len(devs)], **kw)
    assert ours.widths == ref.widths and ours.full.dp == ref.full.dp
    for m in (1, 3, 8, 16, 24, 48, 64, 96, 128, 1000):
        assert ours.rung_for_batch(m).index == ref.rung_for_batch(m).index, m
    assert ours.plan_for_batch(64).dp_size == ref.plan_for_batch(64).dp_size


def test_reshard_and_place():
    """An unchanged rung is a strict no-op; between rungs of one physical
    device nothing moves (donated) or the caller's state is copied."""
    ladder = MeshLadder(CPU8, granule=1)
    state = init_state(small.mlp_init(torch.Generator().manual_seed(0), 8, device="cpu"), sgd(momentum=0.9))
    a, b = ladder.rungs[1].plan, ladder.rungs[3].plan
    assert same_plan(a, a) and not same_plan(a, b) and reshard(state, a, a) is state
    moved = reshard(state, a, b)
    assert moved.params is state.params
    copied = reshard(state, a, b, donate=False)
    assert copied.params is not state.params
    assert all(torch.equal(x, y) for x, y in zip(copied.params.parameters(),
                                                 state.params.parameters()))
    placed = place({"w": np.ones(3, np.float32)}, b)
    assert isinstance(placed["w"], torch.Tensor) and placed["w"].device.type == "cpu"


def test_adapt_state_threads_error_feedback():
    ladder = PodLadder(pods=2, devices=CPU8, granule=16)
    state = init_state(small.logreg_init(torch.Generator().manual_seed(0), D, device="cpu"), sgd())
    assert state.err_state is None
    cross, within = ladder.rungs[3], ladder.rungs[2]
    s1 = ladder.adapt_state(state, None, cross)  # fresh stacked zeros
    assert [tuple(e.shape) for e in s1.err_state] == [
        (2, *p.shape) for p in state.params.parameters()]
    assert all(e.dtype == torch.float32 and not e.any() for e in s1.err_state)
    assert ladder.adapt_state(s1, cross, cross) is s1  # same layout: kept
    assert ladder.adapt_state(s1, cross, within).err_state is None  # dropped
    dirty = s1._replace(err_state=[e + 1.0 for e in s1.err_state])
    back = ladder.adapt_state(dirty, within, cross)  # new layout: re-zeroed
    assert all(not e.any() for e in back.err_state)
    flat = PodLadder(pods=2, devices=CPU8, granule=16, compress=False)
    assert flat.adapt_state(state, None, flat.rungs[3]).err_state is None


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        PodLadder(pods=2)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        PodTopology(2)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        small.mlp_init(gen, 8)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        small.logreg_init(gen, 8)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tdata.put_global_batch({"x": np.ones((2, 3), np.float32)})
    with pytest.raises(RuntimeError, match="no CUDA card"):
        place({"w": np.ones(3, np.float32)}, None)


def test_rungs_over_several_physical_devices_raise():
    ladder = PodLadder(pods=2, devices=["cpu"] * 4 + ["meta"] * 4, granule=1)
    with pytest.raises(NotImplementedError, match="Queue A 5"):
        make_pod_train_step(ladder.rungs[-1], sgd(), loss_fn=small.mlp_batch_loss)
    eng = ladder.engine_for(_fns(), sgd(), estimator="moment")
    eng.rung = 2  # within pod 0: all "cpu", fine
    eng.jitted(64)
    eng.rung = 3
    with pytest.raises(NotImplementedError, match="process groups"):
        eng.jitted(64)


# ---------------------------------------------------------------------------
# the cross-pod step against the reference's, on the 2 x 4 rung
# ---------------------------------------------------------------------------


def _flips(ours: list, theirs: list, scales: np.ndarray) -> tuple[int, float]:
    """(codes that flipped, largest residual difference of the others in
    quanta) between stacked per-pod residuals; ``scales`` is (pods, leaves)."""
    flipped, worst = 0, 0.0
    for i, (a, b) in enumerate(zip(ours, theirs)):
        q = scales[:, i].reshape((-1,) + (1,) * (a.ndim - 1))
        d = np.abs(a - b) / q
        flipped += int((d > 0.5).sum())
        worst = max(worst, float(d[d <= 0.5].max(initial=0.0)))
    return flipped, worst


@pytest.mark.parametrize("estimator", ["moment", "exact"])
def test_pod_train_step_matches_reference(estimator):
    tree, params = _params()
    train, _, _ = sigmoid_synthetic(n=N, d=D, seed=SEED)
    jladder = JPodLadder(pods=2, granule=16)
    jstep = jax.jit(jpod_step.make_pod_train_step(
        jladder.rungs[3], jsgd(momentum=0.9), loss_fn=jsmall.mlp_batch_loss,
        example_loss=jsmall.mlp_loss, estimator=estimator))
    jstate = jladder.adapt_state(jinit_state(tree, jsgd(momentum=0.9)), None,
                                 jladder.rungs[3])
    ladder = PodLadder(pods=2, devices=CPU8, granule=16)
    step = make_pod_train_step(ladder.rungs[3], sgd(momentum=0.9),
                               loss_fn=small.mlp_batch_loss, example_loss=small.mlp_loss,
                               estimator=estimator)
    state = ladder.adapt_state(init_state(params, sgd(momentum=0.9)), None, ladder.rungs[3])
    for i in range(3):
        b = train.get(np.arange(i * 128, (i + 1) * 128))
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                           jnp.float32(0.5))
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()}, 0.5)
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm_sq"].item(), float(jm["grad_norm_sq"]),
                                   rtol=1e-5)
    scales = m["scales"].numpy()
    flipped, worst = _flips([e.numpy() for e in state.err_state],
                            [np.asarray(e) for e in _jleaves(jstate.err_state)], scales)
    assert flipped == 0 and worst < 1e-3, (flipped, worst)
    ours = small_params_to_numpy(state.params)
    for k in ours:
        for n in ours[k]:
            np.testing.assert_allclose(ours[k][n], np.asarray(jstate.params[k][n]),
                                       rtol=0, atol=1e-5)
    jdiv, div = jstate.div_state, state.div_state
    for name in ("sq_norm_sum", "mb_count", "sample_count"):
        np.testing.assert_allclose(getattr(div, name).item(), float(getattr(jdiv, name)),
                                   rtol=1e-5)
    # grad_sum: B x the compressed mean, summed over the 3 steps
    gs = small_params_to_numpy(_module_like(params, div.grad_sum))
    for k in gs:
        for n in gs[k]:
            np.testing.assert_allclose(gs[k][n], np.asarray(jdiv.grad_sum[k][n]),
                                       rtol=0, atol=1e-5 * 128 * 3)
    assert state.step == 3 and div.mb_count.item() == (6.0 if estimator == "moment" else 3.0)


def _jleaves(err_tree) -> list:
    """The reference's stacked residual leaves in the port's parameter order
    (fc1.weight, fc1.bias, fc2.weight, fc2.bias; kernels transposed)."""
    out = []
    for layer in sorted(err_tree):
        out.append(np.swapaxes(np.asarray(err_tree[layer]["kernel"]), 1, 2))
        out.append(np.asarray(err_tree[layer]["bias"]))
    return out


def _module_like(model, named: dict):
    """A copy of ``model`` holding the tensors of ``named`` (keyed by
    parameter name)."""
    import copy

    out = copy.deepcopy(model)
    with torch.no_grad():
        for n, p in out.named_parameters():
            p.copy_(named[n])
    return out


def test_pod_train_step_refusals():
    ladder = PodLadder(pods=2, devices=CPU8, granule=16)
    with pytest.raises(NotImplementedError, match="gram"):
        make_pod_train_step(ladder.rungs[3], sgd(), loss_fn=small.mlp_batch_loss,
                            estimator="gram")
    with pytest.raises(ValueError, match="needs example_loss"):
        make_pod_train_step(ladder.rungs[3], sgd(), loss_fn=small.mlp_batch_loss,
                            estimator="exact")
    with pytest.raises(ValueError, match="'pod'"):
        make_pod_train_step(ladder.rungs[2], sgd(), loss_fn=small.mlp_batch_loss)
    step = make_pod_train_step(ladder.rungs[3], sgd(), loss_fn=small.mlp_batch_loss)
    _, params = _params()
    state = init_state(params, sgd())
    batch = {"x": torch.zeros(64, D), "y": torch.zeros(64, dtype=torch.int32)}
    with pytest.raises(ValueError, match="err_state"):
        step(state, batch, 0.1)
    with pytest.raises(ValueError, match="does not split"):
        step(ladder.adapt_state(state, None, ladder.rungs[3]),
             {k: v[:60] for k, v in batch.items()}, 0.1)


# ---------------------------------------------------------------------------
# the whole slice: Trainer on a two-pod ladder
# ---------------------------------------------------------------------------

SLICE_N = 1024


def _programs(kind):
    if kind == "fixed-128":  # test_pod.py's workload: the cross-pod rung throughout
        return (JProgram(JFixed(128, 1024, granule=16), base_lr=0.5),
                AdaptationProgram(FixedPolicy(128, 1024, granule=16), base_lr=0.5))
    # DiveBatch from 64 (rung 2, pod 0 only) onto the cross-pod rung
    kw = dict(m0=64, m_max=256, delta=1.0, dataset_size=int(SLICE_N * 0.8), granule=16)
    return (JController(jmake_policy("divebatch", **kw), base_lr=0.5),
            AdaptiveBatchController(make_policy("divebatch", **kw), base_lr=0.5))


def _trainers(kind, estimator, epochs):
    tree, params = _params()
    jtrain, jval, _ = sigmoid_synthetic(n=SLICE_N, d=D, seed=SEED)
    train, val, _ = tdata.sigmoid_synthetic(n=SLICE_N, d=D, seed=SEED)
    jprog, prog = _programs(kind)
    jt = JTrainer(_jfns(), tree, jsgd(momentum=0.9), jprog, jtrain, jval,
                  estimator=estimator, seed=SEED, elastic=JPodLadder(pods=2, granule=16))
    t = Trainer(_fns(), params, sgd(momentum=0.9), prog, train, val,
                estimator=estimator, seed=SEED,
                elastic=PodLadder(pods=2, devices=CPU8, granule=16))
    rungs = {"jax": [], "torch": []}
    for _ in range(epochs):
        jt.run_epoch()
        t.run_epoch()
        rungs["jax"].append(jt.rung.index)
        rungs["torch"].append(t.rung.index)
    return jt, t, rungs


def _assert_histories_match(jh, th):
    for a, b in zip(jh, th, strict=True):
        assert (a.epoch, a.batch_size, a.steps) == (b.epoch, b.batch_size, b.steps)
        np.testing.assert_allclose(b.lr, a.lr, rtol=1e-7)
        np.testing.assert_allclose([b.train_loss, b.val_loss], [a.train_loss, a.val_loss],
                                   rtol=1e-4)
        assert set(b.val_metrics) == set(a.val_metrics)
        for k in a.val_metrics:
            np.testing.assert_allclose(b.val_metrics[k], a.val_metrics[k], rtol=1e-4)
        assert (a.diversity is None) == (b.diversity is None)
        if a.diversity is not None:
            np.testing.assert_allclose(b.diversity, a.diversity, rtol=1e-4)


@pytest.mark.parametrize("kind,estimator", [("fixed-128", "exact"),
                                            ("divebatch-64", "exact"),
                                            ("divebatch-64", "moment")])
def test_trainer_on_pod_ladder_matches_reference(kind, estimator):
    """Two epochs on both packages: the rung per epoch, the batch schedule,
    the EpochRecords, the parameters and the residuals."""
    jt, t, rungs = _trainers(kind, estimator, 2)
    assert rungs["torch"] == rungs["jax"]
    assert rungs["torch"][-1] == 3  # on the cross-pod rung
    _assert_histories_match(jt.history, t.history)
    ours = small_params_to_numpy(t.state.params)
    for k in ours:
        for n in ours[k]:
            np.testing.assert_allclose(ours[k][n], np.asarray(jt.state.params[k][n]),
                                       rtol=0, atol=1e-4)
    assert t.engine.stats.as_dict()["rungs"] == jt.engine.stats.as_dict()["rungs"]
    assert t.engine.stats.reshards == jt.engine.stats.reshards
    err = [e.numpy() for e in t.state.err_state]
    assert all(e.shape[0] == 2 for e in err) and sum(np.abs(e).sum() for e in err) > 0
    theirs = _jleaves(jt.state.err_state)
    # the largest possible residual is half a quantum: two runs that agree
    # on every code differ by far less than that
    for a, b in zip(err, theirs):
        assert np.abs(a - b).max() <= max(np.abs(a).max(), np.abs(b).max()) * 1e-2 + 1e-7


def test_demote_drops_residuals_and_training_continues():
    """Losing pod 1 demotes onto the widest all-healthy rung (3 -> 2), the
    residuals drop, and the run carries on, as in the reference."""
    jt, t, _ = _trainers("fixed-128", "exact", 1)
    assert t.state.err_state is not None
    for trainer in (jt, t):
        trainer.elastic.health.mark_lost(1)
    assert t.demote(note="pod 1 lost") == jt.demote(note="pod 1 lost") == (3, 2)
    assert t.rung.pods == 1 and t.state.err_state is None
    before = t.history[-1].val_loss
    for _ in range(2):
        jt.run_epoch()
        t.run_epoch()
    assert t.rung.index == jt.rung.index == 2
    _assert_histories_match(jt.history, t.history)
    assert np.isfinite(t.history[-1].val_loss) and t.history[-1].val_loss <= before
    with pytest.raises(ValueError, match="elastic ladder"):
        Trainer(_fns(), _params()[1], sgd(), AdaptationProgram(FixedPolicy(64, 64), 0.1),
                *tdata.sigmoid_synthetic(n=256, d=D, seed=0)[:2]).demote()
