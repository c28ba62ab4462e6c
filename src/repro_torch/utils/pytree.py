"""Tree helpers the train step uses, over the port's parameter trees.

Counterpart of ``repro/utils/pytree.py``.  A tree here is a dict of tensors
keyed by parameter name (``dict(model.named_parameters())``), a list or
tuple of tensors, or an ``nn.Module`` (its parameters, in
``named_parameters`` order).  Sums of squares accumulate in float32, as the
reference's do.
"""

from __future__ import annotations

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


def tree_sq_norm(tree: Tree) -> torch.Tensor:
    """Squared L2 norm of the concatenated tree, a 0-d float32 tensor."""
    xs = leaves(tree)
    return torch.stack(
        [torch.linalg.vector_norm(x, dtype=torch.float32) for x in xs]
    ).square().sum()


def tree_count(tree: Tree) -> int:
    """Total number of elements."""
    return sum(x.numel() for x in leaves(tree))
