"""Shared pieces of the exact tier's LM parity tests
(``tests/test_torch_exact_lm*.py``).

Both packages take one per-sample loss, the reference's own form:
``example_loss(p, e) = loss_fn(cfg, p, {k: v[None] for k, v in e.items()})[0]``,
the LM loss of one sequence.  The reference runs ``vmap(grad(...))`` under
``jax.jit``, its Pallas flash kernel in interpret mode on the ``pallas``
lane; the port runs ``torch.func.vmap(grad(...))`` on the CPU, where the
kernel wrappers take their plain versions.  Parameters come from the
reference init through ``interop.params_from_jax``; inputs are made with
numpy from a seed.  ``cfg.remat`` is on (the reference configs' default;
their ``reduced()`` turns it off).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jget
from repro.core import diversity as jdiv
from repro.models import transformer as jtf
from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.core import diversity
from repro_torch.models import transformer as tf

SEQ = 32
#: float32 per-sample norms: the house rule for gradients
#: (``tests/test_torch_train.py``); the largest gap seen is 2.8e-6 (jamba)
RTOL = 1e-5
#: the flash lane tiled into several query and key blocks at SEQ
FLASH = dict(attn_impl="flash", flash_q_block=8, flash_kv_block=8)


def pair(arch: str, seed: int = 0, **extra):
    """(jcfg, cfg, jparams, the port's model) with remat on and ``extra``."""
    extra = {"remat": True, **extra}
    jcfg = jget(arch, reduced=True).replace(**extra)
    cfg = get_config(arch, reduced=True).replace(**extra)
    jparams = jtf.init_params(jcfg, jax.random.key(seed))
    return jcfg, cfg, jparams, interop.params_from_jax(jax.tree.map(np.asarray, jparams), cfg)


def batch(cfg, seed: int, n: int = 3, seq: int = SEQ) -> dict:
    """``n`` sequences: tokens or frame embeddings, and their targets."""
    r = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        toks = r.integers(1, cfg.vocab_size, size=(n, seq + 1)).astype(np.int32)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    return {"embeddings": r.standard_normal((n, seq, cfg.d_model)).astype(np.float32),
            "targets": r.integers(0, cfg.vocab_size, size=(n, seq)).astype(np.int32)}


def jax_example_loss(jcfg):
    return lambda p, e: jtf.loss_fn(jcfg, p, jax.tree.map(lambda v: v[None], e))[0]


def port_example_loss(cfg):
    return lambda p, e: tf.loss_fn(cfg, p, {k: v[None] for k, v in e.items()})[0]


def jax_sq_norms(jcfg, jparams, b: dict) -> np.ndarray:
    fn = jax.jit(lambda p, x: jdiv.persample_sq_norms(jax_example_loss(jcfg), p, x))
    return np.asarray(fn(jparams, {k: jnp.asarray(v) for k, v in b.items()}))


def port_sq_norms(cfg, model, b: dict) -> torch.Tensor:
    return diversity.persample_sq_norms(port_example_loss(cfg), model,
                                        {k: torch.from_numpy(v) for k, v in b.items()})


def check_sq_norms(arch: str, extra: dict, seed: int = 0) -> None:
    """The port's per-sample norms of 3 sequences against the reference's,
    within :data:`RTOL`."""
    jcfg, cfg, jparams, model = pair(arch, seed, **extra)
    b = batch(cfg, seed + 1)
    got = port_sq_norms(cfg, model, b)
    want = jax_sq_norms(jcfg, jparams, b)
    assert got.shape == (3,) and np.all(np.isfinite(want)) and np.all(want > 0)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
