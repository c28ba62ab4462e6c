"""Print the losses of ``chip_smoke.py`` phase 6's training run bit for bit.

  python3 tools/phase6_losses.py [--root DIR] [--steps 12]

Yi-6B widths at 8 of 32 layers in bf16 with remat, weights from the seeded
card generator, micro batch 2, sequences of 2048 tokens, under phase 6's
DiveBatch program (m0 4, m_max 16, delta 0.5, a tick every 4 steps), trained
through ``train_lm.train`` with ``attn_impl="pallas"`` on one card.  The
``repro_torch`` package comes from ``DIR/src`` (this checkout by default),
so two checkouts unpacked side by side can be run one after the other on
the same card and their losses compared to the bit: each step prints its
batch and its loss as ``float.hex``, then one line holds them all.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--steps", type=int, default=12)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train_lm
    from repro_torch.models import transformer as tf

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    cfg = get_config("yi-6b").replace(num_layers=8)
    params = tf.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    program = train_lm.make_program("divebatch", m0=4, m_max=16, delta=0.5, granule=2,
                                    lr=0.02, tick_every=4)
    out = train_lm.train(cfg, params, program, steps=args.steps, seq_len=2048,
                         micro_batch=2, attn_impl="pallas", log=lambda line: None)
    losses = [float(rec["loss"]).hex() for rec in out["records"]]
    for rec, bits in zip(out["records"], losses):
        print(f"step {rec['step']:2d}: batch {rec['batch']:2d}, loss {bits}")
    print(f"losses of {Path(args.root).resolve().name}: {' '.join(losses)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
