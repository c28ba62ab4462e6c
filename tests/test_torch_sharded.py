"""The training state sharded at run time by the reference's rules, on the
CPU: gloo ranks spawned from ``tests/_scaleout_ranks.py`` (a ``FileStore`` in
``tmp_path``, one thread each, a deadline per spawn; those tests carry the
``slow`` marker, the lane of the repo's process-group tests).

  * (a) every leaf's shard shape and offset on rank meshes ``(data 2)``,
    ``(data 2, model 2)``, ``(data 4, model 2)`` and ``(pod 2, data 2,
    model 2)`` (rung roles: ``dp = fsdp = ep`` the data axes, ``tp =
    model``) against the reference's ``NamedSharding(...).shard_shape`` and
    ``devices_indices_map`` on the 8 forced host devices, for the ten
    reduced configs' whole train state; and each port parameter's shard
    (``dist.sharding.param_pspecs``, through ``interop.layout``) against the
    reference leaf's, transposed and unstacked.  Shapes only: nothing runs
    on several devices.  Exact;
  * (b) shard / unshard round trips bit for bit, leaf and tree forms, and
    ``gradcheck`` in float64 of the autograd gather over each axis of a
    2-rank and a 4-rank rung;
  * (c) reduced Yi-6B (the moment tier under a DiveBatch program, the gram
    and the exact tier), dbrx-132b at ``moe_groups=2`` and with
    ``moe_impl="ep"`` (its experts resident, at capacity 8.0 where nothing
    drops, against ``moe_apply``), and falcon-mamba-7b on a 2-rank ``(data 2)`` and a 4-rank ``(data 2, model 2)`` rung
    against the one-process whole run and the reference's single-device
    ``make_train_step(dp_size=2)``: the schedule and buckets exact, losses
    within 1e-5 relative, ``sq_norm_sum`` within 1e-5, the gathered
    parameters within 1e-5 relative plus 5e-5 of each tensor's RMS (the
    bound of ``test_torch_scaleout.py``), and each rank holding exactly
    the elements the specs reckon;
  * (d) ``elastic.reshard`` across a 2-rank ladder's rungs (2 ranks, 1,
    2 again; the rank that leaves gathers and waits) against the
    one-process run of the same steps;
  * (e) checkpoints: a save of the 2-rank sharded state equals the
    one-process save of the same state byte for byte, and restores onto a
    4-rank rung and onto one process.

The rank work runs in two spawns (2 ranks, then 4) shared by the module's
tests.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

sys.path.insert(0, os.path.dirname(__file__))

import _scaleout_ranks as ranks  # noqa: E402
from repro import adapt as jadapt  # noqa: E402
from repro.configs import ARCH_NAMES  # noqa: E402
from repro.configs import get_config as jget  # noqa: E402
from repro.data import TokenStream as JTokenStream  # noqa: E402
from repro.dist.plan import ShardingPlan as JPlan  # noqa: E402
from repro.models import probes as jprobes  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro.train import StepEngine as JStepEngine  # noqa: E402
from repro.train import init_state as jinit_state  # noqa: E402
from repro.train import make_train_step as jmake_train_step  # noqa: E402
from repro.utils.pytree import _path_str  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.ckpt import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import TokenStream  # noqa: E402
from repro_torch.dist import sharding  # noqa: E402
from repro_torch.dist.plan import ShardingPlan, abstract_mesh  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402
from repro_torch.train import init_state, make_train_step  # noqa: E402

torch.set_num_threads(2)

MESHES = [((2,), ("data",)), ((2, 2), ("data", "model")), ((4, 2), ("data", "model")),
          ((2, 2, 2), ("pod", "data", "model"))]


def _plans(shape, axes):
    """(the reference's plan on a mesh of the forced host devices, the
    port's on an abstract mesh): the rung roles."""
    dp = tuple(a for a in axes if a != "model")
    tp = "model" if "model" in axes else None
    n = int(np.prod(shape))
    jmesh = JMesh(np.asarray(jax.devices()[:n]).reshape(shape), axes)
    return (JPlan(mesh=jmesh, dp=dp, fsdp=dp, tp=tp, ep=dp),
            ShardingPlan(mesh=abstract_mesh(shape, axes), dp=dp, fsdp=dp, tp=tp, ep=dp))


def _flat(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path_str(path): leaf for path, leaf in flat}


def _jspec(spec) -> JP:
    return JP(*spec)


# ---------------------------------------------------------------------------
# (a) shard shapes and offsets
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m[0])))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_shard_shapes_and_offsets_match_reference(arch, mesh):
    """Every leaf of the whole train state: the shard shape and each
    device's slices; each port parameter's shard through the layout."""
    jcfg = jget(arch, reduced=True)
    state = jax.eval_shape(lambda p: jinit_state(p, jsgd(momentum=0.9)),
                           jtf.param_specs(jcfg))
    jplan, plan = _plans(*mesh)
    tree = _flat(state)
    specs = sharding.infer_pspecs(tree, plan)
    jmesh = jplan.mesh
    positions = {d: dict(zip(jmesh.axis_names, (int(i) for i in idx)))
                 for idx, d in np.ndenumerate(jmesh.devices)}
    sharded = 0
    for path, leaf in tree.items():
        shape = tuple(leaf.shape)
        ns = NamedSharding(jmesh, _jspec(specs[path]))
        assert sharding.local_shape(shape, specs[path], plan) == tuple(ns.shard_shape(shape))
        for dev, idx in ns.devices_indices_map(shape).items():
            want = tuple(s.indices(n)[:2] for s, n in zip(idx, shape))
            got = tuple((s.start, s.stop) for s in sharding.local_slices(
                shape, specs[path], plan.mesh.shape, positions[dev]))
            assert got == want, (path, dev)
        sharded += any(e is not None for e in specs[path])
    assert sharded > 0
    # the port's parameters: the reference leaf's shard, unstacked and transposed
    cfg = get_config(arch, reduced=True)
    model = tf.build(cfg, "meta")
    pspecs = sharding.param_pspecs(model, plan)
    params = dict(model.named_parameters())
    for leaf in interop.layout(model):
        ref_shape = tuple(tree[f"params/{leaf.path}"].shape)
        ref_shard = NamedSharding(jmesh, _jspec(specs[f"params/{leaf.path}"])).shard_shape(
            ref_shape)
        if leaf.stacked:
            assert ref_shard[0] == ref_shape[0]  # the repeats axis stays whole
            ref_shard = ref_shard[1:]
        perm = sharding._FORM_PERM.get(leaf.form, tuple(range(len(ref_shard))))
        want = [0] * len(ref_shard)
        for j, size in enumerate(ref_shard):
            want[perm[j]] = size
        for name in leaf.names:
            got = sharding.local_shape(tuple(params[name].shape), pspecs[name], plan)
            assert got == tuple(want), (name, got, want)


# ---------------------------------------------------------------------------
# (b) collectives
# ---------------------------------------------------------------------------


SPECS = {2: [[(8, 6), ["data", None]], [(4, 6, 10), [None, None, "data"]]]}
SPECS[4] = SPECS[2] + [[(8, 4), ["data", "model"]], [(6, 4), [None, "model"]],
                       [(8, 4), [["data", "model"], None]]]


@pytest.mark.slow
@pytest.mark.parametrize("world", [2, 4], ids=["data2", "data2xmodel2"])
def test_shard_roundtrip_and_gather_gradcheck(rank_runs, world):
    got = rank_runs["got"][world]
    for r in range(world):
        assert all(ok for _, ok in got[r]["sharded_collectives"]["roundtrip"])
        grad = got[r]["sharded_collectives"]["gradcheck"]
        assert grad and all(grad.values()), grad
    shard_shapes = [s for s, _ in got[0]["sharded_collectives"]["roundtrip"] if s]
    assert shard_shapes[0] == [4, 6] and shard_shapes[1] == [4, 6, 5]
    if world == 4:
        assert shard_shapes[2:] == [[4, 2], [6, 2], [2, 4]]


# ---------------------------------------------------------------------------
# (c) sharded training against the one-process run and the reference
# ---------------------------------------------------------------------------

SEQ = ranks.SEQ
CASES_2 = [
    {"name": "falcon", "arch": "falcon-mamba-7b", "params": "falcon", "seed": 7},
    {"name": "yi_exact", "arch": "yi-6b", "params": "yi", "seed": 8, "tier": "exact",
     "steps": 2},
    {"name": "dbrx_ep", "arch": "dbrx-132b", "params": "dbrx", "seed": 5, "moe_groups": 2,
     "extra": {"moe_impl": "ep", "capacity_factor": 8.0}},
]
CASES_4 = [
    {"name": "yi_program", "arch": "yi-6b", "params": "yi", "seed": 1, "program": True},
    {"name": "dbrx", "arch": "dbrx-132b", "params": "dbrx", "seed": 4, "moe_groups": 2},
    {"name": "falcon", "arch": "falcon-mamba-7b", "params": "falcon", "seed": 7},
    {"name": "yi_gram", "arch": "yi-6b", "params": "yi", "seed": 3, "tier": "gram"},
    {"name": "dbrx_ep", "arch": "dbrx-132b", "params": "dbrx", "seed": 5, "moe_groups": 2,
     "extra": {"moe_impl": "ep", "capacity_factor": 8.0}},
]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _reference(case: dict, jparams) -> dict:
    """The reference's single-device ``make_train_step(dp_size=2)`` run of
    a case (``StepEngine.for_lm`` under the program for ``program``);
    ``moe_impl="ep"`` runs ``moe_apply`` there (no plan), at a capacity
    where nothing drops, in one routing group per rank's share (the aux
    loss of each, averaged, as the ranks average theirs)."""
    jcfg = jget(case["arch"], reduced=True).replace(**case.get("extra", {}))
    tier = case.get("tier", "moment")
    stream = JTokenStream(jcfg.vocab_size, seed=case["seed"])
    out = {"loss": [], "sq_norm_sum": [], "batch": [], "diversity": []}
    if case.get("program"):
        eng = JStepEngine.for_lm(jcfg, jsgd(momentum=0.9), micro_batch=4, dp_size=2,
                                 attn_impl="pallas")
        state, program = jinit_state(jparams, jsgd(momentum=0.9)), ranks.lm_program(jadapt)
        m = program.batch_size
        for step in range(6):
            b = {k: jax.numpy.asarray(v) for k, v in stream.batch(step, m, SEQ).items()}
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
    else:
        kw = {}
        if tier == "gram":
            jcfg = jcfg.replace(scan_layers=False)
            kw = dict(probe_loss=lambda p, pr, b: jprobes.loss_with_probes(jcfg, p, pr, b),
                      probe_specs=lambda p, n: jprobes.probe_specs(jcfg, n, SEQ),
                      psn_interpret=True)
        elif tier == "exact":
            kw = dict(example_loss=lambda p, e: jtf.loss_fn(
                jcfg, p, jax.tree.map(lambda v: v[None], e))[0], psn_chunk=2)
        step = jax.jit(jmake_train_step(jcfg, jsgd(momentum=0.9), 2, dp_size=2,
                                        estimator=tier, moe_groups=case.get("moe_groups", 1),
                                        **kw))
        state = jinit_state(jparams, jsgd(momentum=0.9))
        for i in range(case.get("steps", 3)):
            b = {k: jax.numpy.asarray(v) for k, v in stream.batch(i, 8, SEQ).items()}
            state, metrics = step(state, b, jax.numpy.float32(0.1))
            out["loss"].append(float(metrics["loss"]))
            out["sq_norm_sum"].append(float(state.div_state.sq_norm_sum))
    out["params"] = _np_tree(state.params)
    return out


def _whole(case: dict, jparams) -> dict:
    """The port's one-process run of a case with whole state (``dp_size=2``
    lays the batch out as the ranks split it)."""
    cfg = get_config(case["arch"], reduced=True).replace(**case.get("extra", {}))
    if case.get("program"):
        return None  # the program case is held against the reference only
    tier = case.get("tier", "moment")
    kw = {}
    if tier == "gram":
        from repro_torch.models import probes

        kw = dict(probe_loss=lambda p, pr, b: probes.loss_with_probes(cfg, p, pr, b),
                  probe_specs=lambda p, n: probes.probe_specs(cfg, n, SEQ, device="cpu"))
    elif tier == "exact":
        kw = dict(example_loss=lambda p, e: tf.loss_fn(
            cfg, p, {k: v[None] for k, v in e.items()})[0], psn_chunk=2)
    opt = sgd(momentum=0.9)
    state = init_state(interop.params_from_jax(_np_tree(jparams), cfg), opt)
    step = make_train_step(cfg, opt, 2, dp_size=2, estimator=tier,
                           moe_groups=case.get("moe_groups", 1), **kw)
    stream = TokenStream(cfg.vocab_size, seed=case["seed"])
    out = {"loss": [], "sq_norm_sum": []}
    for i in range(case.get("steps", 3)):
        state, metrics = step(state, stream.batch(i, 8, SEQ), 0.1)
        out["loss"].append(float(metrics["loss"]))
        out["sq_norm_sum"].append(state.div_state.sq_norm_sum.item())
    out["params"] = {n: p.detach().numpy() for n, p in state.params.named_parameters()}
    out["numel"] = sum(p.numel() for p in state.params.parameters())
    return out


def _close(got: np.ndarray, want: np.ndarray):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=5e-5 * np.sqrt(np.mean(want ** 2)))


@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory):
    """One spawn of 2 ranks (the collectives, the training cases, the
    checkpoint, the rung transitions) and then one of 4 (the collectives,
    the training cases, the restore of the 2 ranks' checkpoint), and the
    one-process runs they are held against."""
    jparams = {"yi": jtf.init_params(jget("yi-6b", reduced=True), jax.random.key(2)),
               "dbrx": jtf.init_params(jget("dbrx-132b", reduced=True), jax.random.key(6)),
               "falcon": jtf.init_params(jget("falcon-mamba-7b", reduced=True),
                                         jax.random.key(9))}
    args = {k: _np_tree(v) for k, v in jparams.items()}
    extra = {"ckpt_params": _np_tree(jtf.init_params(jget("yi-6b", reduced=True),
                                                     jax.random.key(11))),
             "rungs_params": _np_tree(jtf.init_params(jget("yi-6b", reduced=True),
                                                      jax.random.key(13)))}
    root = tmp_path_factory.mktemp("ck")
    got = {2: ranks.spawn_ranks(
               tmp_path_factory.mktemp("r2"),
               "sharded_collectives+sharded_train+sharded_ckpt+sharded_rungs",
               {**args, **extra, "shape": (2,), "cases": CASES_2, "specs": SPECS[2],
                "root": str(root)}, 2),
           4: ranks.spawn_ranks(
               tmp_path_factory.mktemp("r4"), "sharded_collectives+sharded_train+sharded_restore",
               {**args, "shape": (2, 2), "cases": CASES_4, "specs": SPECS[4],
                "root": str(root)}, 4)}
    cases = {c["name"]: c for c in CASES_2 + CASES_4}
    want = {name: _reference(c, jparams[c["params"]]) for name, c in cases.items()}
    whole = {name: _whole(c, jparams[c["params"]]) for name, c in cases.items()}
    return {"got": got, "want": want, "whole": whole, "cases": cases, "root": root,
            **extra}


@pytest.mark.slow
@pytest.mark.parametrize("world,name", [(2, c["name"]) for c in CASES_2]
                         + [(4, c["name"]) for c in CASES_4])
def test_sharded_training_matches_reference_and_whole_run(rank_runs, world, name):
    got, want, whole, cases = (rank_runs[k] for k in ("got", "want", "whole", "cases"))
    case = cases[name]
    cfg = get_config(case["arch"], reduced=True)
    w = want[name]
    jref = {leaf.path: leaf for leaf in interop.layout(tf.build(cfg, "meta"))}
    for r in range(world):
        g = got[world][r]["sharded_train"][name]
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
        if case.get("program"):
            assert g["batch"] == w["batch"] and len(set(w["batch"])) > 1
            assert g["buckets"] == w["buckets"]
            np.testing.assert_allclose(g["diversity"], w["diversity"], rtol=1e-4)
        else:
            np.testing.assert_allclose(g["sq_norm_sum"], w["sq_norm_sum"], rtol=1e-5)
            o = whole[name]
            np.testing.assert_allclose(g["loss"], o["loss"], rtol=1e-5)
            np.testing.assert_allclose(g["sq_norm_sum"], o["sq_norm_sum"], rtol=1e-5)
            for n, v in o["params"].items():
                _close(g["params"][n], v)
        # the gathered parameters against the reference's tree
        flat = _flat(w["params"])
        for path, leaf in jref.items():
            ref = np.asarray(flat[path])
            for i, n in enumerate(leaf.names):
                part = ref[i] if leaf.stacked else ref
                part = part.T if leaf.form == "t" else part
                _close(g["params"][n], part)
        if case.get("extra", {}).get("moe_impl") == "ep":
            assert g["ep_backward"]  # the remat recompute outside the step's plan
        # each rank holds the elements its specs reckon, and fewer than whole
        assert g["held"] == g["reckoned"] and g["sharded"] > 0
        total = sum(v.size for v in g["params"].values())
        assert g["held"] < total


# ---------------------------------------------------------------------------
# (e) checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_sharded_checkpoint_bytes_and_restores(rank_runs):
    """The 2-rank sharded state's save equals the one-process save of the
    gathered state byte for byte; the save restores onto 4 ranks and onto
    one process, and one more step there agrees with the 2-rank run."""
    root = rank_runs["root"]
    rec = rank_runs["got"][2][0]["sharded_ckpt"]
    # against the one-process save of the gathered state, written by rank 0
    step = "step_0000000002"
    for name in ("params", "opt_state", "div_state"):
        files = sorted(os.listdir(root / "sharded" / step / name))
        assert files == sorted(os.listdir(root / "whole" / step / name))
        for f in files:
            a = (root / "sharded" / step / name / f).read_bytes()
            b = (root / "whole" / step / name / f).read_bytes()
            assert a == b, (name, f)
    for res in (rank_runs["got"][4][r]["sharded_restore"] for r in range(4)):
        np.testing.assert_allclose(res["loss"], rec["next_loss"], rtol=1e-5)
        assert res["step"] == rec["step"]
    # one process: a state from other weights, restored, its third step
    cfg = get_config("yi-6b", reduced=True)
    opt = sgd(momentum=0.9)
    state = init_state(tf.init_params(cfg, torch.Generator().manual_seed(5), "cpu"), opt)
    ref = interop.reference_state(state, target=True)
    out, _ = CheckpointManager(str(root / "sharded")).restore(
        {"params": ref.params, "opt_state": ref.opt_state, "div_state": ref.div_state})
    state = interop.load_reference_state(state, step=2, **out)
    state, metrics = make_train_step(cfg, opt, 2, dp_size=2)(
        state, TokenStream(cfg.vocab_size, seed=12).batch(2, 8, SEQ), 0.1)
    np.testing.assert_allclose(float(metrics["loss"]), rec["next_loss"], rtol=1e-5)


# ---------------------------------------------------------------------------
# (d) rung transitions
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_reshard_across_rungs_matches_one_process(rank_runs):
    jparams = rank_runs["rungs_params"]
    got = rank_runs["got"][2]
    cfg = get_config("yi-6b", reduced=True)
    opt = sgd(momentum=0.9)
    state = init_state(interop.params_from_jax(jparams, cfg), opt)
    stream = TokenStream(cfg.vocab_size, seed=13)
    want = []
    for i, dp in enumerate((2, 1, 2)):
        state, metrics = make_train_step(cfg, opt, 2, dp_size=dp)(
            state, stream.batch(i, 8, SEQ), 0.1)
        want.append(float(metrics["loss"]))
    whole = sum(p.numel() for p in state.params.parameters())
    r0, r1 = got[0]["sharded_rungs"], got[1]["sharded_rungs"]
    np.testing.assert_allclose(r0["loss"], want, rtol=1e-5)
    np.testing.assert_allclose(r1["loss"], [want[0], want[2]], rtol=1e-5)
    assert r0["held"][1] == whole and r0["held"][0] == r0["held"][2] < whole
    assert r1["held"] == [r0["held"][0], r0["held"][2]] and r1["same"]
    for n, p in state.params.named_parameters():
        for r in (r0, r1):
            _close(r["params"][n], p.detach().numpy())
