"""Carry parameters between the JAX reference and the port.

``params_from_jax`` takes the reference ``repro.models.transformer
.init_params`` tree with every leaf converted to a numpy array (the caller
does ``jax.tree.map(np.asarray, params)``; this module never imports JAX)
and returns the port's ``Transformer`` with the same weights, so both
packages compute with identical numbers; ``trainable=True`` gives
parameters that take gradients.  ``params_to_numpy`` is the reverse: the
port's model as the reference's tree of numpy arrays, so a test can hold
parameters after a training step against the reference's leaf by leaf.
``small_params_from_jax`` / ``small_params_to_numpy`` do the same for the
paper's small models (``repro.models.small``: the ``logreg_init`` and
``mlp_init`` dicts).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import small
from repro_torch.models import transformer as tf


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: exact through float32
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_jax(tree: dict, cfg: ModelConfig, *, trainable: bool = False
                    ) -> tf.Transformer:
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
    return model.requires_grad_(trainable)


def _array(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().float().numpy() if t.dtype == torch.bfloat16 \
        else t.detach().cpu().numpy()


def params_to_numpy(model: tf.Transformer, cfg: ModelConfig) -> dict:
    """The reference's parameter tree of ``model``'s weights as numpy
    arrays: pattern positions stacked over repeats, dense kernels in
    ``(d_in, d_out)`` layout (bf16 weights come back as float32)."""

    def linear(lins: list) -> dict:
        out = {"kernel": np.stack([_array(lin.weight).T for lin in lins])}
        if lins[0].bias is not None:
            out["bias"] = np.stack([_array(lin.bias) for lin in lins])
        return out

    def scale(norms: list) -> dict:
        return {"scale": np.stack([_array(n.scale) for n in norms])}

    tree: dict = {
        "embed": {"embedding": _array(model.embed.weight)},
        "final_norm": {"scale": _array(model.final_norm.scale)},
        "lm_head": {"kernel": _array(model.lm_head.weight).T},
    }
    for p in range(cfg.period):
        blks = [model.blocks[r * cfg.period + p] for r in range(cfg.repeats)]
        pos = {"norm": scale([b.norm for b in blks]),
               "attn": {n: linear([getattr(b.attn, n) for b in blks])
                        for n in ("q", "k", "v", "o")}}
        if blks[0].ffn is not None:
            pos["ffn_norm"] = scale([b.ffn_norm for b in blks])
            names = ("w_gate", "w_up", "w_out") if cfg.ffn_glu else ("w_in", "w_out")
            pos["ffn"] = {n: linear([getattr(b.ffn, n) for b in blks]) for n in names}
        tree[f"pos{p}"] = pos
    return tree


def small_params_from_jax(tree: dict, *, trainable: bool = True):
    """The port's ``Logreg`` (a ``{"linear": ...}`` tree) or ``MLP`` (a
    ``{"fc1": ..., "fc2": ...}`` tree) on the CPU with the weights of
    ``tree``, kernels transposed into ``nn.Linear``'s layout."""
    if set(tree) == {"linear"}:
        d = np.asarray(tree["linear"]["kernel"]).shape[0]
        model = small.Logreg(d)
    elif set(tree) == {"fc1", "fc2"}:
        d, hidden = np.asarray(tree["fc1"]["kernel"]).shape
        model = small.MLP(d, hidden)
    else:
        raise ValueError(f"not a small-model tree: keys {sorted(tree)}")
    with torch.no_grad():
        for name, leaf in tree.items():
            lin = getattr(model, name)
            lin.weight.copy_(_tensor(leaf["kernel"]).t())
            lin.bias.copy_(_tensor(leaf["bias"]))
    return model.requires_grad_(trainable)


def small_params_to_numpy(model) -> dict:
    """The reference's tree of a ``Logreg`` or ``MLP`` as numpy arrays."""
    return {name: {"kernel": _array(lin.weight).T, "bias": _array(lin.bias)}
            for name, lin in model.named_children()}
