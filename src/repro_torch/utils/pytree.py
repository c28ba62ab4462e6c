"""Tree helpers the train step uses, over the port's parameter trees.

Counterpart of ``repro/utils/pytree.py``.  A tree here is a dict of tensors
keyed by parameter name (``dict(model.named_parameters())``), a list or
tuple of tensors, or an ``nn.Module`` (its parameters, in
``named_parameters`` order).  Sums of squares accumulate in float32, as the
reference's do.

:func:`tree_flatten_with_paths` names a transformer's leaves as the
reference names its parameter tree (``interop.layout``: ``embed/embedding``,
``pos0/ffn/w_gate``, a stacked ``(repeats, ...)`` leaf per pattern
position), so rules written against the reference's paths read the port's
models; :func:`tree_bytes` counts a tree's bytes.
"""

from __future__ import annotations

import math
from typing import Any

import torch
from torch import nn

Tree = Any


def leaves(tree: Tree) -> list[torch.Tensor]:
    """The tensors of ``tree`` in a fixed order."""
    if isinstance(tree, nn.Module):
        return list(tree.parameters())
    if isinstance(tree, dict):
        return list(tree.values())
    return list(tree)


def tree_zeros_like(tree: Tree, dtype: torch.dtype | None = None) -> dict | list:
    """Zeros shaped like every leaf (in ``dtype`` when given); a module or
    dict gives a dict keyed by name, a list a list."""
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, dict):
        return {k: torch.zeros_like(x, dtype=dtype or x.dtype) for k, x in tree.items()}
    return [torch.zeros_like(x, dtype=dtype or x.dtype) for x in tree]


def tree_sq_norm(tree: Tree, layout: Any = None) -> torch.Tensor:
    """Squared L2 norm of the concatenated tree, a 0-d float32 tensor.
    With ``layout`` (a ``dist.sharding.StateLayout``; the tree's leaves are
    its shards, in parameter order) the norm of the whole tree: each element
    counted once over the mesh (``StateLayout.sq_norm``, a collective)."""
    xs = leaves(tree)
    if layout is not None:
        return layout.sq_norm(xs)
    return torch.stack(
        [torch.linalg.vector_norm(x, dtype=torch.float32) for x in xs]
    ).square().sum()


def tree_flatten_with_paths(tree: Tree) -> list[tuple[str, torch.Tensor]]:
    """``(path, leaf)`` pairs.  A model gives the reference's parameter
    leaves (``interop.layout``: its paths, and its shapes, transposed and
    stacked over the repeats) as ``meta`` tensors of the parameters' type;
    a nested dict, list or tuple its ``/``-joined paths, in the reference's
    flatten order (dict keys sorted)."""
    if isinstance(tree, nn.Module):
        from repro_torch import interop  # interop imports the models
        from repro_torch.dist.sharding import _FORM_PERM, full_shapes

        shapes = full_shapes(tree)
        named = dict(tree.named_parameters())
        out = []
        for leaf in interop.layout(tree):
            shape = shapes[leaf.names[0]]
            if leaf.form:
                shape = tuple(shape[j] for j in _FORM_PERM[leaf.form])
            if leaf.stacked:
                shape = (len(leaf.names),) + tuple(shape)
            out.append((leaf.path, torch.empty(shape, dtype=named[leaf.names[0]].dtype,
                                               device="meta")))
        return out
    from repro_torch.ckpt.checkpoint import tree_flatten_with_paths as flat

    return [(p, t) for p, t in flat(tree) if isinstance(t, torch.Tensor)]


def tree_bytes(tree: Tree) -> int:
    """Bytes of every tensor of ``tree`` (a model's parameters, whole
    shapes under a sharded layout; a nested dict, list or tuple)."""
    if isinstance(tree, nn.Module):
        from repro_torch.dist.sharding import full_shapes

        named = dict(tree.named_parameters())
        return sum(math.prod(shape) * named[n].element_size()
                   for n, shape in full_shapes(tree).items())
    return sum(t.numel() * t.element_size() for _, t in tree_flatten_with_paths(tree))


def tree_count(tree: Tree) -> int:
    """Total number of elements."""
    return sum(x.numel() for x in leaves(tree))
