"""How far float32 rounding can carry a short training run of a reduced
config, on the CPU.

  PYTHONPATH=src python tools/train_drift.py --arch jamba-v0.1-52b --lr 0.05
  PYTHONPATH=src python tools/train_drift.py --arch jamba-v0.1-52b --lr 0.01

Runs ``chip_smoke.py`` phase 22's card-against-CPU training (the reference's
reduced config in float32, weights from ``torch.Generator`` seed 2,
``train_lm.train`` with a DiveBatch program: m0 4, m_max 16, delta 0.5,
granule 2, a tick every 2 steps; micro batch 2, S 64, ``moe_groups`` 2 for a
MoE config) twice on the CPU: as it is, and with every weight multiplied by
``1 + eps * N(0, 1)`` (``--eps``, default 1e-7, about an ulp).  Prints the
largest relative gap of the losses and the largest absolute gap of the
parameters after ``--steps`` steps: the spread a card-against-CPU check of
that run must leave to rounding.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config
from repro_torch.launch import train_lm
from repro_torch.models import transformer as tf


def run(arch: str, steps: int, lr: float, eps: float):
    cfg = get_config(arch, reduced=True).replace(attn_impl="pallas")
    model = tf.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    if eps:
        gen = torch.Generator().manual_seed(9)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + eps * torch.randn(p.shape, generator=gen))
    program = train_lm.make_program("divebatch", m0=4, m_max=16, delta=0.5, granule=2,
                                    lr=lr, tick_every=2)
    out = train_lm.train(cfg, model, program, steps=steps, seq_len=64, micro_batch=2,
                         attn_impl="pallas", moe_groups=2 if cfg.num_experts else 1,
                         log=lambda line: None)
    return model, [rec["loss"] for rec in out["records"]]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="jamba-v0.1-52b")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--eps", type=float, default=1e-7)
    args = ap.parse_args()
    torch.set_num_threads(4)
    base, base_losses = run(args.arch, args.steps, args.lr, 0.0)
    moved, moved_losses = run(args.arch, args.steps, args.lr, args.eps)
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(moved_losses, base_losses))
    worst = max(((a - b).abs().max().item(), name) for (name, a), b in
                zip(moved.named_parameters(), base.parameters()))
    print(f"{args.arch}, {args.steps} steps at lr {args.lr}, weights moved by {args.eps:g} "
          f"relative: losses {base_losses}; loss gap {loss_gap:.3e} relative; parameter gap "
          f"{worst[0]:.3e} (largest at {worst[1]})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
