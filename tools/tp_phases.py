"""Run ``chip_smoke.py``'s tensor-parallel training phases alone on one card.

  cd CHECKOUT && python3 /path/to/tools/tp_phases.py

Imports ``chip_smoke`` and ``repro_torch`` from the working directory (the
root of a checkout), builds the kernels, then runs phase 25 (its gloo
spawn also runs phases 30's and 33's ranks and their one-process runs),
phase 30's checks, phase 32 (its own spawn of 4 gloo ranks and the offset
kernels) and phase 33's checks, and prints each one's wall seconds.  Two
checkouts unpacked side by side (a parent and its change) can be run in
turns from one command, parent, change, change, parent, to compare their
step times, collectives and peaks on the same card.
"""

import subprocess
import sys
import time

sys.path.insert(0, "src")
sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True
                         ).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    cs._build.build_all()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    secs = {}
    for name, fn in (("25", cs.sharded_phase), ("30", cs.tp_phase), ("32", cs.cp_phase),
                     ("33", cs.mamba_tp_phase)):
        t1 = time.perf_counter()
        fn()
        secs[name] = round(time.perf_counter() - t1, 1)
    print(f"phase seconds {secs}; done in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
