"""The dry run's fake-world collectives against the collectives 2 gloo
ranks issue, on the CPU.

The reference's reduced Yi-6B (as ``tests/test_torch_sharded.py`` runs it,
without remat, and with remat as the dry run plans it) and reduced
dbrx-132b (two MoE groups) each take one sharded ``make_train_step`` step
of 2 microbatches on a ``(data 2)`` rung of 2 gloo ranks, spawned from
``tests/_scaleout_ranks.py``; the ``dist.plan`` helpers report every
collective they issue.  The dry run traces the same cell on rank 0 of a
fake world of 2 (one microbatch, extrapolated to 2).  Kinds, counts and
operand bytes must be equal, exactly, on every rank.
"""

import pytest
import torch

import _scaleout_ranks as ranks
from repro_torch.configs import get_config
from repro_torch.launch import dryrun

torch.set_num_threads(2)

CASES = [
    {"name": "yi", "arch": "yi-6b", "num_micro": 2, "batch": 8, "seq": 32},
    {"name": "yi_remat", "arch": "yi-6b", "extra": {"remat": True}, "num_micro": 2,
     "batch": 8, "seq": 32},
    {"name": "dbrx", "arch": "dbrx-132b", "moe_groups": 2, "num_micro": 2, "batch": 8,
     "seq": 32},
]


@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory):
    return ranks.spawn_ranks(tmp_path_factory.mktemp("dryrun"), "dryrun_collectives",
                             {"cases": CASES}, 2)


@pytest.mark.slow
@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_fake_world_collectives_equal_the_ranks(rank_runs, case):
    cfg = get_config(case["arch"], reduced=True).replace(**case.get("extra", {}))
    with dryrun.fake_world(2):
        plan = ranks.rung_plan((2,))
        got = dryrun.trace_train(cfg, plan, case["batch"] // case["num_micro"], case["seq"],
                                 case["num_micro"], torch.float32,
                                 moe_groups=case.get("moe_groups", 1))
    traced = {kind: [int(d["count"]), int(d["operand_bytes"])]
              for kind, d in got["analysis"]["collectives"]["by_kind"].items()}
    assert {"all-gather", "reduce-scatter", "all-reduce"} <= set(traced)
    for r in (0, 1):
        assert rank_runs[r]["dryrun_collectives"][case["name"]] == traced, r
