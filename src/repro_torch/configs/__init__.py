"""Config registry of the port: the architectures whose paths exist.

Two are ported: ``yi-6b`` (pure full attention, dense SwiGLU; training and
serving) and ``hubert-xlarge`` (the encoder: non-causal attention at head
dim 80, an embedding frontend, layer norm, a GELU MLP; encoding through
``transformer.prefill_step`` and training, no decode).  The reference
package's other eight archs need MoE, SSM, windowed or embedding-decode
paths that are still on the ROADMAP (Queue A 7), and asking for one raises.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import FLASH_THRESHOLD, ModelConfig

_MODULES = {
    "yi-6b": "yi_6b",
    "hubert-xlarge": "hubert_xlarge",
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
