"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes``.  The build runs at
first use, on the machine with the card, into ``build/repro_torch_kernels/``
at the root of the checkout; a library's file name carries a hash of its
sources and flags, so an edited source rebuilds and an unchanged one is
reused.  :func:`build_all` starts one ``nvcc`` per source at once.

Nothing here runs at import: the CPU tests import every module of the
package on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: source name -> (entry point, argtypes); every entry returns a cudaError_t
SIGNATURES = {
    "chunk_attention": (
        "chunk_attention_fwd",
        # dtype, q, k, v, q_pos, k_pos, k_valid, out, lse,
        # B, C, Sk, H, KV, hd, scale, softcap, window, stream
        [_I, _P, _P, _P, _P, _P, _P, _P, _P,
         _I, _I, _I, _I, _I, _I, _F, _F, _I, _P],
    ),
    "chunk_attention_tc": (
        "chunk_attention_tc_fwd",
        # chunk_attention_fwd's arguments (dtype must be bfloat16)
        [_I, _P, _P, _P, _P, _P, _P, _P, _P,
         _I, _I, _I, _I, _I, _I, _F, _F, _I, _P],
    ),
    "paged_decode": (
        "paged_decode_fwd",
        # dtype, q, pool_k, pool_v, tables, lengths, out, part,
        # B, H, KV, hd, num_blocks, blk, n_max, splits, scale, softcap, stream
        [_I, _P, _P, _P, _P, _P, _P, _P,
         _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P],
    ),
    "flash_dq": (
        "flash_dq_bwd",
        # dtype, q, k, v, dout, lse, delta, dq,
        # B, S, H, KV, hd, scale, softcap, window, stream
        [_I, _P, _P, _P, _P, _P, _P, _P,
         _I, _I, _I, _I, _I, _F, _F, _I, _P],
    ),
    "flash_dq_tc": (
        "flash_dq_tc_bwd",
        # flash_dq_bwd's arguments (dtype must be bfloat16)
        [_I, _P, _P, _P, _P, _P, _P, _P,
         _I, _I, _I, _I, _I, _F, _F, _I, _P],
    ),
    "flash_dkv": (
        "flash_dkv_bwd",
        # dtype, q, k, v, dout, lse, delta, dk, dv,
        # B, S, H, KV, hd, scale, softcap, window, stream
        [_I, _P, _P, _P, _P, _P, _P, _P, _P,
         _I, _I, _I, _I, _I, _F, _F, _I, _P],
    ),
    "flash_dkv_tc": (
        "flash_dkv_tc_bwd",
        # flash_dkv_bwd's arguments (dtype must be bfloat16)
        [_I, _P, _P, _P, _P, _P, _P, _P, _P,
         _I, _I, _I, _I, _I, _F, _F, _I, _P],
    ),
    "psgn_direct": (
        "psgn_direct_fwd",
        # x_dtype, d_dtype, x, delta, partials, out, L, B, S, Din, Dout,
        # n_partials, stream
        [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    ),
    "psgn_gram": (
        "psgn_gram_fwd",
        # x_dtype, d_dtype, x, delta, partials, out, B, S, Din, Dout,
        # n_partials, stream
        [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    ),
    "psgn_direct_tc": (
        "psgn_direct_tc_fwd",
        # x term pointers, delta term pointers (host arrays of L x T), L,
        # T term pairs, partials, out, B, S, Din, Dout, n_partials, stream
        [_P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _I, _P],
    ),
    "psgn_split": (
        "psgn_split_fwd",
        # source pointers (a host array), n_src, n, terms, stream
        [_P, _I, _I, _P, _P],
    ),
    "psgn_gram_tc": (
        "psgn_gram_tc_fwd",
        # x, delta, partials, out, B, S, Din, Dout, n_partials, stream
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    ),
    "quant_int8": (
        "quant_int8_fwd",
        # dtype, x, q, scales, amax scratch, R, C, stream
        [_I, _P, _P, _P, _P, _I, _I, _P],
    ),
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: source name -> {"seconds": build time (0.0 when reused), "ptxas": [lines]}
#: (ptxas's register and shared-memory lines and its spill counts)
BUILD_INFO: dict[str, dict] = {}


def _nvcc_candidates() -> list[str]:
    return [os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then
    ``/usr/local/cuda/bin``; raises when there is none."""
    for cand in _nvcc_candidates():
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the repro_torch CUDA kernels are built on the machine with the card"
    )


def _sources(name: str) -> list[Path]:
    return [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]


def library_path(name: str) -> Path:
    """Where the library of source ``name`` lands (content-hashed name)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources(name):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}.{h.hexdigest()[:12]}.so"


def command(name: str, out: Path) -> list[str]:
    return [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out),
            str(CSRC / f"{name}.cu")]


def _start(name: str):
    """Start the nvcc of ``name`` unless its library exists; returns
    ``(final path, temp path, process, start time)`` or None."""
    path = library_path(name)
    if path.exists():
        BUILD_INFO.setdefault(name, {"seconds": 0.0, "ptxas": []})
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(command(name, tmp), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return path, tmp, proc, time.perf_counter()


def _finish(name: str, started) -> None:
    path, tmp, proc, t0 = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, path)  # atomic: a concurrent build sees whole files only
    BUILD_INFO[name] = {
        "seconds": time.perf_counter() - t0,
        "ptxas": [ln.strip() for ln in log.splitlines() if "ptxas" in ln or "spill" in ln],
    }


def build_all() -> dict[str, dict]:
    """Build every kernel library that is not built yet, one ``nvcc`` per
    source, all started together.  Returns :data:`BUILD_INFO`."""
    with _lock:
        started = {n: _start(n) for n in SIGNATURES}
        for n, s in started.items():
            if s is not None:
                _finish(n, s)
    return BUILD_INFO


def library(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built first if needed, with
    ``argtypes``/``restype`` declared on its entry point."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        started = _start(name)
        if started is not None:
            _finish(name, started)
        lib = ctypes.CDLL(str(library_path(name)))
        entry, argtypes = SIGNATURES[name]
        fn = getattr(lib, entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _libs[name] = lib
        return lib
