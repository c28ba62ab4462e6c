"""repro_torch — the PyTorch/CUDA port of ``repro``, one slice at a time.

The JAX package ``repro`` (beside this one) is the reference the port is
held against; this package imports ``torch``, numpy and the standard library
and never ``jax`` or anything of ``repro``.  ``repro_torch/<sub>/<module>.py``
mirrors ``repro/<sub>/<module>.py``.

The port carries paged serving (``serve.ServeEngine`` over
``models.transformer``), DiveBatch LM training (``train.StepEngine`` with
the ``adapt`` layer, the moment and gram tiers), and the paper's own
``train.loop.Trainer`` on its small models, elastic over a two-pod
``pod.PodLadder`` of virtual devices with the compressed cross-pod
gradient exchange (``dist.compression``).  Every TPU kernel of the
reference has a hand-written Hopper counterpart in ``kernels/csrc/``: chunk
attention, paged decode, the flash-attention backward, the per-sample
gradient norms and the int8 quantisation.  Every entry point defaults to ``device="cuda"`` and
raises on a machine without a capable card (:func:`resolve_device`); it never
moves to the CPU by itself.  The CPU runs only when the caller asks for it,
and there every kernel wrapper takes its plain PyTorch version.
"""

from __future__ import annotations

import torch

#: the entry points' default device
DEFAULT_DEVICE = "cuda"

#: the kernels are built for sm_90a (Hopper)
MIN_CAPABILITY = (9, 0)


def resolve_device(device: str | torch.device = DEFAULT_DEVICE) -> torch.device:
    """The ``torch.device`` for ``device``; a CUDA device must exist and be
    Hopper or newer (capability >= 9.0), otherwise this raises."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"repro_torch runs on 'cuda' or 'cpu', got {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but no CUDA card is available; pass "
            f"device='cpu' explicitly to run the plain PyTorch path"
        )
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    cap = torch.cuda.get_device_capability(dev)
    if cap < MIN_CAPABILITY:
        raise RuntimeError(
            f"{torch.cuda.get_device_name(dev)} has compute capability "
            f"{cap[0]}.{cap[1]}; the repro_torch kernels need sm_90a "
            f"(capability >= {MIN_CAPABILITY[0]}.{MIN_CAPABILITY[1]})"
        )
    return dev


__all__ = ["DEFAULT_DEVICE", "MIN_CAPABILITY", "resolve_device"]
