"""The exact tier's per-sample gradient norms on the MoE, Mamba and
encoder LMs, the port against the JAX reference, on the CPU
(``tests/_exact_lm.py`` says how both sides run), and remat under
``torch.func``.

``diversity.persample_sq_norms`` of ``vmap(grad(example_loss))`` over 3
sequences of the reference's reduced configs, float32, remat on: dbrx-132b
and kimi-k2-1t-a32b (the MoE FFN routes each sequence alone, one group),
falcon-mamba-7b (the scan in chunks), jamba-v0.1-52b (Mamba, attention and
MoE) and hubert-xlarge through its frame embeddings (non-causal), on the
lanes that apply.  Tolerance: 1e-5 relative (``tests/_exact_lm.py``).

Inside a ``torch.func`` transform the port runs the layers and the scan
chunks without ``torch.utils.checkpoint`` (torch.func cannot run it): remat
on and off give the same norms to the bit.
"""

import pytest
import torch

from _exact_lm import FLASH, batch, check_sq_norms, pair, port_sq_norms
from repro_torch.models import moe
from repro_torch.models import transformer as tf

torch.set_num_threads(2)

CASES = {
    "dbrx-132b-dense": ("dbrx-132b", dict(attn_impl="dense")),
    "dbrx-132b-pallas": ("dbrx-132b", dict(attn_impl="pallas")),
    "kimi-k2-1t-a32b-flash": ("kimi-k2-1t-a32b", FLASH),
    "falcon-mamba-7b": ("falcon-mamba-7b", {}),
    "jamba-v0.1-52b-pallas": ("jamba-v0.1-52b", dict(attn_impl="pallas")),
    "hubert-xlarge-pallas": ("hubert-xlarge", dict(attn_impl="pallas")),
    "hubert-xlarge-dense": ("hubert-xlarge", dict(attn_impl="dense")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_persample_sq_norms_match_reference(case):
    arch, extra = CASES[case]
    check_sq_norms(arch, extra)


@pytest.mark.parametrize("case", ["yi-6b-pallas", "falcon-mamba-7b", "jamba-v0.1-52b-pallas",
                                  "hubert-xlarge-pallas"])
def test_remat_on_and_off_give_the_same_norms(case):
    """Remat changes no result: inside the transform both run the same ops."""
    arch, extra = {"yi-6b-pallas": ("yi-6b", dict(attn_impl="pallas")), **CASES}[case]
    _, cfg, _, model = pair(arch, 3, **extra)
    b = batch(cfg, 4)
    on = port_sq_norms(cfg, model, b)
    off = port_sq_norms(cfg.replace(remat=False), model, b)
    assert torch.isfinite(on).all()
    torch.testing.assert_close(on, off, rtol=0, atol=0)


def test_moe_counts_stay_out_of_the_per_sample_pass():
    """``MoE.stats`` counts the main pass's calls and none of the
    per-sample pass's (its tensors are batched)."""
    _, cfg, _, model = pair("dbrx-132b", 5)
    layers = [m for m in model.modules() if isinstance(m, moe.MoE)]
    assert len(layers) == cfg.num_layers
    for m in layers:
        m.stats = {}
    b = batch(cfg, 6)

    def counts():
        return [{k: float(v) for k, v in m.stats.items()} for m in layers]

    tf.loss_fn(cfg, model, {k: torch.from_numpy(v) for k, v in b.items()})
    before = counts()
    assert all(s["assignments"] == 3 * 32 * cfg.top_k for s in before)
    port_sq_norms(cfg, model, b)
    assert counts() == before
