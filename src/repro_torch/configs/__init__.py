"""Config registry of the port: the architectures whose serving path exists.

Only ``yi-6b`` (pure full attention, dense SwiGLU) is ported so far.  The
reference package's other nine archs need MoE, SSM, windowed or encoder
paths that are still on the ROADMAP (Queue A 7), and asking for one raises.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import FLASH_THRESHOLD, ModelConfig

_MODULES = {
    "yi-6b": "yi_6b",
}


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(
            f"arch {name!r} is not ported to repro_torch yet (ROADMAP.md, "
            f"Queue A 7); ported: {sorted(_MODULES)}"
        )
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.reduced() if reduced else mod.CONFIG


__all__ = ["ModelConfig", "FLASH_THRESHOLD", "get_config"]
