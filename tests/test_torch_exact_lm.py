"""The exact tier's per-sample gradient norms on the dense LMs, the port
against the JAX reference, on the CPU (``tests/_exact_lm.py`` says how
both sides run).

``diversity.persample_sq_norms`` of ``vmap(grad(example_loss))`` over 3
sequences of the reference's reduced configs, float32, remat on, on every
attention lane that applies: ``pallas`` (the kernel lane: the port's
kernel wrappers fold the vmapped axis into B, their plain versions here;
the reference's Pallas kernel in interpret mode), ``flash`` (the XLA lane,
tiled into 8-token blocks; gemma2 with both softcaps and its window) and
``dense``.  Tolerance: 1e-5 relative (``tests/_exact_lm.py``).
"""

import pytest
import torch

from _exact_lm import FLASH, check_sq_norms

torch.set_num_threads(2)

CASES = {
    "yi-6b-pallas": ("yi-6b", dict(attn_impl="pallas")),
    "yi-6b-dense": ("yi-6b", dict(attn_impl="dense")),
    "gemma2-27b-flash": ("gemma2-27b", FLASH),
    "gemma2-27b-pallas": ("gemma2-27b", dict(attn_impl="pallas")),
    "qwen2-7b-pallas": ("qwen2-7b", dict(attn_impl="pallas")),
    "llama3-405b-flash": ("llama3-405b", FLASH),
    "internvl2-1b-pallas": ("internvl2-1b", dict(attn_impl="pallas")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_persample_sq_norms_match_reference(case):
    arch, extra = CASES[case]
    check_sq_norms(arch, extra)
