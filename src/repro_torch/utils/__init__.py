"""Tree helpers over the port's parameter dicts."""

from repro_torch.utils import pytree

__all__ = ["pytree"]
