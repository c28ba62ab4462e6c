"""Carry parameters from the JAX reference into the port.

``params_from_jax`` takes the reference ``repro.models.transformer
.init_params`` tree with every leaf converted to a numpy array (the caller
does ``jax.tree.map(np.asarray, params)``; this module never imports JAX)
and returns the port's ``Transformer`` with the same weights, so both
packages compute with identical numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: exact through float32
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_jax(tree: dict, cfg: ModelConfig) -> tf.Transformer:
    """The port's model (on the CPU) holding the weights of ``tree``.

    The reference stacks each pattern position ``pos{p}`` over a leading
    repeats axis and stores dense kernels as ``(d_in, d_out)``; layer
    ``r * period + p`` takes slice ``r`` of ``pos{p}``, and every kernel is
    transposed into ``nn.Linear``'s ``(d_out, d_in)``."""
    model = tf.build(cfg, "cpu", _tensor(tree["embed"]["embedding"]).dtype)

    def put(dst: torch.Tensor, src: torch.Tensor) -> None:
        if dst.shape != src.shape:
            raise ValueError(f"shape {tuple(src.shape)} does not fit {tuple(dst.shape)}")
        dst.copy_(src)

    def linear(lin: torch.nn.Linear, leaf: dict, r: int | None) -> None:
        kernel = _tensor(leaf["kernel"])
        put(lin.weight, (kernel if r is None else kernel[r]).t())
        if "bias" in leaf:
            bias = _tensor(leaf["bias"])
            put(lin.bias, bias if r is None else bias[r])

    with torch.no_grad():
        put(model.embed.weight, _tensor(tree["embed"]["embedding"]))
        put(model.final_norm.scale, _tensor(tree["final_norm"]["scale"]))
        linear(model.lm_head, tree["lm_head"], None)
        for layer, blk in enumerate(model.blocks):
            r, p = divmod(layer, cfg.period)
            src = tree[f"pos{p}"]
            put(blk.norm.scale, _tensor(src["norm"]["scale"])[r])
            for name in ("q", "k", "v", "o"):
                linear(getattr(blk.attn, name), src["attn"][name], r)
            if blk.ffn is not None:
                put(blk.ffn_norm.scale, _tensor(src["ffn_norm"]["scale"])[r])
                for name in ("w_gate", "w_up", "w_in", "w_out"):
                    if name in src["ffn"]:
                        linear(getattr(blk.ffn, name), src["ffn"][name], r)
    return model
