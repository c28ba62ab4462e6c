"""Config registry of the port: every architecture of the reference package.

Ten are ported: the dense decoders ``yi-6b`` (pure full attention, dense
SwiGLU), ``qwen2-7b`` (QKV bias), ``llama3-405b``, ``gemma2-27b``
(alternating sliding-window ``attn_local`` and global ``attn`` layers, an
attention and a final logit softcap, GELU) and ``internvl2-1b`` (an
embedding frontend in front of a dense decoder), trained and served; the
MoE decoders ``dbrx-132b`` (16 experts, top 4) and ``kimi-k2-1t-a32b`` (384
experts, top 8, head dim 112), trained and served through
``models/moe.py``; the Mamba archs ``falcon-mamba-7b`` (attention-free,
no FFN) and ``jamba-v0.1-52b`` (a period of 8: seven Mamba layers and one
attention layer, dense and MoE FFNs alternating), trained and served
through ``models/ssm.py``; and ``hubert-xlarge`` (the encoder: non-causal
attention at head dim 80, an embedding frontend, layer norm, a GELU MLP;
encoding through ``transformer.prefill_step`` and training, no decode).

``SHAPES``, ``cell_supported`` and :func:`input_specs` are the reference's
shape table and its stand-ins for a cell's inputs, which the dry run
(``launch/dryrun.py``) plans.
"""

from __future__ import annotations

import importlib

import torch

from repro_torch.configs.base import (
    ENCODER_ONLY_ARCHS,
    FLASH_THRESHOLD,
    FULL_ATTENTION_ARCHS,
    SHAPES,
    ModelConfig,
    ShapeConfig,
    cell_supported,
)

_MODULES = {
    "yi-6b": "yi_6b",
    "qwen2-7b": "qwen2_7b",
    "llama3-405b": "llama3_405b",
    "gemma2-27b": "gemma2_27b",
    "internvl2-1b": "internvl2_1b",
    "dbrx-132b": "dbrx_132b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "hubert-xlarge": "hubert_xlarge",
}

#: the ported architectures, in registry order
ARCH_NAMES = tuple(_MODULES)


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; ported: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.reduced() if reduced else mod.CONFIG


def input_specs(cfg: ModelConfig, shape: ShapeConfig, batch_override: int | None = None,
                seq_override: int | None = None) -> dict:
    """Stand-ins on the ``meta`` device (no storage: the counterpart of the
    reference's ``ShapeDtypeStruct``) for the model inputs of a cell.

    train/prefill: the token (or stub-embedding) batch, plus targets for
    train.  decode: one new token per sequence and the KV/SSM cache sized to
    ``seq_len``, as ``transformer.cache_specs`` builds it."""
    from repro_torch.models import transformer as tf  # the models import the configs

    b = batch_override or shape.global_batch
    s = seq_override or shape.seq_len
    f = getattr(torch, cfg.compute_dtype)

    def spec(shp, dtype):
        return torch.empty(shp, dtype=dtype, device="meta")

    if cfg.input_mode == "tokens":
        inputs = {"tokens": spec((b, s), torch.int32)}
    else:
        inputs = {"embeddings": spec((b, s, cfg.d_model), f)}
    if shape.kind == "train":
        inputs["targets"] = spec((b, s), torch.int32)
        return {"batch": inputs}
    if shape.kind == "prefill":
        return {"batch": inputs}
    if cfg.input_mode == "tokens":
        tok = spec((b, 1), torch.int32)
    else:
        tok = spec((b, 1, cfg.d_model), f)
    return {"tokens": tok, "cache": tf.cache_specs(cfg, b, s)}


__all__ = ["ARCH_NAMES", "ModelConfig", "ShapeConfig", "SHAPES", "FLASH_THRESHOLD",
           "FULL_ATTENTION_ARCHS", "ENCODER_ONLY_ARCHS", "get_config", "cell_supported",
           "input_specs"]
