"""The port's distribution rules against the reference's, on the CPU, with
no process spawned.

  * ``dist.sharding``'s ``infer_pspecs``, ``batch_pspecs`` and
    ``cache_pspecs`` entry for entry against ``repro.dist.sharding``'s, on
    the path and shape lists of the reference's ``jax.eval_shape`` inits
    (the whole train state: parameters, momenta, diversity accumulators)
    for all 10 reference configs at ``reduced=True``, their input specs and
    decode caches, on abstract meshes of several shapes, a multi-pod mesh
    among them; ``shardings_of``'s DTensor placements from those specs;
  * ``launch.mesh.make_plan`` against the reference's on meshes of the same
    shapes, with and without ``param_bytes`` over the pod threshold;
  * ``train.step._to_micro`` with ``dp_size`` against the reference's
    relayout, exactly, and each rank's share (``_rank_micro``) against the
    reference microbatch's rows;
  * the refusals: two NCCL ranks on one device, a microbatch that does not
    split over the ranks, a rank mesh without a process group;
  * a rank mesh over a world of one (gloo, a ``FileStore``): its groups,
    and ``for_lm`` under its plan equal to the run without a plan to the
    bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import ARCH_NAMES, SHAPES, input_specs
from repro.configs import get_config as jget
from repro.dist import sharding as jsharding
from repro.dist.plan import abstract_mesh as jabstract_mesh
from repro.launch.mesh import make_plan as jmake_plan
from repro.models import transformer as jtf
from repro.optim import sgd as jsgd
from repro.train import init_state as jinit_state
from repro.train.step import _to_micro as j_to_micro
from repro.utils.pytree import _path_str
from repro_torch.configs import get_config
from repro_torch.data import TokenStream
from repro_torch.dist import sharding
from repro_torch.dist.plan import Mesh, RankDevice, ShardingPlan, abstract_mesh, rank_devices
from repro_torch.launch import mesh as lmesh
from repro_torch.models import transformer as tf
from repro_torch.optim import sgd
from repro_torch.train import StepEngine, init_state
from repro_torch.train.step import _rank_micro, _to_micro

torch.set_num_threads(2)

MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((4, 2), ("data", "model")), ((2, 2, 2), ("pod", "data", "model")),
          ((1, 8), ("data", "model"))]


def _flat(tree, is_leaf=None) -> list[tuple[str, object]]:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return [(_path_str(path), leaf) for path, leaf in flat]


def _specs(tree) -> list[tuple[str, tuple]]:
    return [(p, tuple(s)) for p, s in
            _flat(tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))]


def _plans(shape, axes, **kw):
    return (jmake_plan(jabstract_mesh(shape, axes), **kw),
            lmesh.make_plan(abstract_mesh(shape, axes), **kw))


def _assert_same(got: dict, want: list):
    assert list(got) == [p for p, _ in want]
    for path, spec in want:
        assert tuple(got[path]) == spec, (path, got[path], spec)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m[0])))
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_infer_pspecs_match_reference(arch, mesh):
    """The whole train state's specs, entry for entry, and the placements
    they map to."""
    jcfg = jget(arch, reduced=True)
    state = jax.eval_shape(lambda p: jinit_state(p, jsgd(momentum=0.9)),
                           jtf.param_specs(jcfg))
    jplan, plan = _plans(*mesh)
    tree = dict(_flat(state))
    want = _specs(jsharding.infer_pspecs(state, jplan))
    got = sharding.infer_pspecs(tree, plan)
    _assert_same(got, want)
    placed = sharding.shardings_of(got, plan)
    for path, spec in got.items():
        for i, axis in enumerate(plan.mesh.axis_names):
            dims = [d for d, e in enumerate(spec)
                    if e == axis or (isinstance(e, tuple) and axis in e)]
            p = placed[path][i]
            assert (p.is_shard() and [p.dim] == dims) or (p.is_replicate() and not dims)


@pytest.mark.parametrize("mesh", MESHES[:2], ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_batch_and_cache_pspecs_match_reference(arch, mesh):
    """Every shape's input specs, a decode cache at the decode shape and a
    batch-1 long-context cache (the sequence fallback), and a serve block
    pool."""
    jcfg = jget(arch, reduced=True)
    jplan, plan = _plans(*mesh)
    for shape in SHAPES.values():
        specs = input_specs(jcfg, shape)
        want = _specs(jsharding.batch_pspecs(specs, jplan))
        _assert_same(sharding.batch_pspecs(dict(_flat(specs)), plan), want)
    caches = [jtf.cache_specs(jcfg, 128, 4096), jtf.cache_specs(jcfg, 1, 65536),
              jax.eval_shape(lambda: jtf.init_pages(jcfg, 256, 16))]
    for cache in caches:
        want = _specs(jsharding.cache_pspecs(cache, jplan))
        _assert_same(sharding.cache_pspecs(dict(_flat(cache)), plan), want)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(map(str, m[0])))
def test_make_plan_matches_reference(mesh):
    jplan, plan = _plans(*mesh)
    assert (plan.dp, plan.fsdp, plan.tp, plan.ep) == (jplan.dp, jplan.fsdp, jplan.tp, jplan.ep)
    # the reference's rule reads mesh.devices.size, which jax's AbstractMesh
    # refuses: it is given the port's abstract mesh, which has one
    for kw in ({"param_bytes": 10 << 30}, {"param_bytes": 1 << 50},
               {"param_bytes": 1 << 30, "fsdp_pod_threshold": 1}):
        jplan = jmake_plan(abstract_mesh(*mesh), **kw)
        plan = lmesh.make_plan(abstract_mesh(*mesh), **kw)
        assert (plan.dp, plan.fsdp, plan.tp, plan.ep) == \
            (jplan.dp, jplan.fsdp, jplan.tp, jplan.ep)
        assert (plan.dp_size, plan.fsdp_size, plan.tp_size) == \
            (jplan.dp_size, jplan.fsdp_size, jplan.tp_size)


@pytest.mark.parametrize("b,num_micro,dp", [(8, 2, 2), (16, 4, 2), (12, 3, 2), (24, 2, 4),
                                             (8, 4, 4), (6, 1, 3), (8, 8, 1), (10, 5, 2)])
def test_to_micro_matches_reference(b, num_micro, dp):
    """The relayout exactly (including the reference's plain reshape when
    the microbatch does not split), and each rank's share is its block of
    every reference microbatch."""
    x = np.arange(b * 3, dtype=np.int32).reshape(b, 3)
    want = np.asarray(j_to_micro(jnp.asarray(x), num_micro, dp))
    np.testing.assert_array_equal(_to_micro(torch.from_numpy(x), num_micro, dp).numpy(),
                                  want)
    m = b // num_micro
    if m % dp:
        return
    for r in range(dp):
        share = _rank_micro(torch.from_numpy(x), num_micro, dp, [r]).numpy()
        np.testing.assert_array_equal(share, want[:, r * (m // dp):(r + 1) * (m // dp)])
        # rank r's rows are the contiguous block [r B/dp, (r+1) B/dp)
        np.testing.assert_array_equal(share.reshape(-1, 3),
                                      x[r * b // dp:(r + 1) * b // dp])


def test_refusals():
    with pytest.raises(ValueError, match="NCCL needs a card per rank"):
        lmesh.rank_device("nccl", 1, 2, device_count=1)
    assert lmesh.rank_device("gloo", 1, 2, device_count=1) == torch.device("cuda", 0)
    assert lmesh.rank_device("nccl", 1, 2, device_count=2) == torch.device("cuda", 1)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        lmesh.rank_device("nccl", 0, 1, "cpu")
    with pytest.raises(ValueError, match="backend"):
        lmesh.init_ranks("mpi")
    with pytest.raises(ValueError, match=r"bucket lattice .* granule that is a multiple of 4"):
        _rank_micro(torch.zeros(12, 2), 2, 4, [0])
    if not dist.is_initialized():
        with pytest.raises(RuntimeError, match="init_ranks"):
            Mesh(rank_devices("cpu", 2), ("data",))
    with pytest.raises(ValueError, match="all devices or all RankDevice"):
        Mesh(["cpu", RankDevice(0, "cpu")], ("data",))


def test_world_of_one(tmp_path):
    """A rank mesh over a world of one gloo rank: its groups, and 4
    DiveBatch steps of ``for_lm`` under its plan equal to the same steps
    without a plan, losses and parameters to the bit."""
    assert not dist.is_initialized()
    lmesh.init_ranks("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                     world=1, device="cpu")
    try:
        mesh = lmesh.make_production_mesh(multi_pod=False, device="cpu")
        assert mesh.ranked and mesh.shape == {"data": 1, "model": 1}
        assert mesh.group_ranks("data") == (0,) and mesh.is_member and mesh.root == 0
        assert mesh.local_positions("data") == [0]
        plan = lmesh.make_plan(mesh)
        cfg = get_config("yi-6b", reduced=True).replace(attn_impl="pallas")
        runs = []
        for p in (None, plan):
            params = tf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
            eng = StepEngine.for_lm(cfg, sgd(momentum=0.9), micro_batch=2, plan=p)
            state = init_state(params, sgd(momentum=0.9))
            stream = TokenStream(cfg.vocab_size, seed=0)
            losses = []
            for step in range(4):
                state, metrics = eng.step(state, stream.batch(step, 4, 16), 0.1)
                losses.append(metrics["loss"].item())
            runs.append((losses, [t.detach().clone() for t in params.parameters()]))
        assert runs[0][0] == runs[1][0]
        for a, b in zip(runs[0][1], runs[1][1]):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()
