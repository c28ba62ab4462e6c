"""``models/moe_ep.py::moe_apply_ep`` (the expert-parallel MoE FFN: tokens
to their experts' ranks and back by two all-to-alls) on 8 gloo ranks of a
``(pod 2, data 2, model 2)`` mesh, the mesh of the reference's
``tests/test_moe_ep.py``: each rank one row of ``x`` (4, 16, 32) and 2 of
the 8 experts.

  * at capacity factor 8.0 (nothing drops) the output within 2e-5 of the
    JAX ``moe_reference`` and of the port's, and the gradients of ``sum(y **
    2)`` on each rank's experts within 5e-4 relative of ``jax.grad``
    through the reference;
  * at 0.5, where assignments drop, the output and the aux loss equal the
    reference's ``moe_apply_ep`` run as its own test runs it (a subprocess
    with 8 host devices, the same mesh shape), within 2e-5.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import _scaleout_ranks as ranks  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.models import moe  # noqa: E402

pytestmark = pytest.mark.slow  # 8 ranks spawned (the repo's lane for process groups)

D, FF, E, TOPK = 32, 64, 8, 2
FACTORS = (8.0, 0.5)

_REFERENCE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro.models import moe as moe_lib
from repro.models.moe_ep import moe_apply_ep

mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
params = moe_lib.moe_init(jax.random.key(0), 32, 64, 8)
x = jax.random.normal(jax.random.key(1), (4, 16, 32))
with mesh:
    y, aux = jax.jit(lambda x: moe_apply_ep(
        params, x, top_k=2, capacity_factor=0.5, act="silu", mesh=mesh,
        dp_axes=("pod", "data"), ep_axes=("pod", "data"), tp_axis="model"))(x)
np.save(sys.argv[1], np.asarray(y))
print(json.dumps({"aux": float(aux)}))
"""


@pytest.fixture(scope="module")
def ep_runs(tmp_path_factory):
    params = jmoe.moe_init(jax.random.key(0), D, FF, E)
    x = jax.random.normal(jax.random.key(1), (4, 16, D))
    weights = jax.tree.map(np.asarray, params)
    tmp = tmp_path_factory.mktemp("ep")
    got = ranks.spawn_ranks(tmp, "moe_ep", {"moe": weights, "x": np.asarray(x),
                                            "factors": FACTORS}, 8)
    res = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(tmp / "y.npy")], capture_output=True,
        text=True, env={**os.environ, "PYTHONPATH": "src"}, timeout=600,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert res.returncode == 0, res.stderr[-3000:]
    ref = {"y": np.load(tmp / "y.npy"), **json.loads(res.stdout.strip().splitlines()[-1])}
    return params, np.asarray(x), got, ref


def _rows(got, factor) -> np.ndarray:
    """The global output from the ranks of model position 0, by row."""
    rows = {}
    for r in range(8):
        g = got[r]["moe_ep"][factor]
        rows.setdefault(g["row"], g["y"])
        np.testing.assert_array_equal(rows[g["row"]], g["y"])  # the tp ranks agree
    return np.concatenate([rows[k] for k in range(4)])


def test_moe_apply_ep_matches_moe_reference(ep_runs):
    params, x, got, _ = ep_runs
    want = np.asarray(jmoe.moe_reference(params, jnp.asarray(x), top_k=TOPK))
    y = _rows(got, 8.0)
    assert float(np.abs(y - want).max()) < 2e-5
    assert all(got[r]["moe_ep"][8.0]["dropped"] == 0 for r in range(8))
    # the port's dense oracle agrees with the reference's
    layer = moe.init_moe(D, FF, E, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        layer.router.weight.copy_(torch.from_numpy(np.asarray(params["router"]["kernel"])).t())
        for n in ("w_gate", "w_up", "w_out"):
            getattr(layer, n).copy_(torch.from_numpy(np.asarray(params[n])))
    port = moe.moe_reference(layer, torch.from_numpy(x), top_k=TOPK).numpy()
    assert float(np.abs(y - port).max()) < 2e-5


def test_moe_apply_ep_gradients_match_reference(ep_runs):
    params, x, got, _ = ep_runs

    def loss(p):
        return (jmoe.moe_reference(p, jnp.asarray(x), top_k=TOPK) ** 2).sum()

    g_ref = jax.grad(loss)(params)
    for name in ("w_gate", "w_up", "w_out"):
        blocks = {}
        for r in range(8):
            g = got[r]["moe_ep"][8.0]
            blocks.setdefault(g["row"], g["grads"][name])
        mine = np.concatenate([blocks[k] for k in range(4)])
        want = np.asarray(g_ref[name])
        assert float(np.abs(mine - want).max()) / float(np.abs(want).max()) < 5e-4, name


def test_moe_apply_ep_drops_like_the_reference(ep_runs):
    _, _, got, ref = ep_runs
    y = _rows(got, 0.5)
    assert sum(got[r]["moe_ep"][0.5]["dropped"] for r in range(8)) > 0
    assert float(np.abs(y - ref["y"]).max()) < 2e-5
    for r in range(8):
        assert abs(got[r]["moe_ep"][0.5]["aux"] - ref["aux"]) < 2e-5
