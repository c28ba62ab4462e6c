"""Tree helpers over the port's parameter dicts (``pytree``), and the dry
run's cost model of a traced step (``hlo``, imported on its own)."""

from repro_torch.utils import pytree

__all__ = ["pytree"]
