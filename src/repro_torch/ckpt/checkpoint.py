"""Fault-tolerant checkpointing in the reference's on-disk format.

Counterpart of ``repro/ckpt/checkpoint.py``; a checkpoint written by either
package loads in the other.

  * ATOMIC: a checkpoint is staged in ``<root>/.tmp.step_<10 digits>`` and
    published with a single ``os.rename`` to ``step_<10 digits>``, so a
    crash mid-save never leaves a restorable half checkpoint.
  * LOGICAL: each named tree is a directory of ``vol<v>.npz`` volumes (a new
    volume starts once one passes 512 MB) and a ``meta.json`` index
    ``{"index": {path: {volume, key, shape, dtype}}, "num_volumes"}``;
    ``extra.json`` holds ``{"step", ...}``.  Leaves are keyed by the
    reference's tree paths (``/``-joined dict keys, sequence indices and
    record fields), so the file does not depend on the device it came from.
  * SYNCHRONOUS COPY: every leaf is copied to the host before ``save``
    returns, so a step that then updates the state in place cannot race the
    write; only the file I/O may run on a thread (``async_save=True``).
  * BOUNDED: the ``keep`` most recent steps are retained.

Trees are nested dicts (flattened in sorted key order, as JAX flattens
them), lists and tuples (by index), and named tuples (by field, in field
order); ``None`` holds no leaf.  A leaf is a tensor, a numpy array, a
Python number, or a function of no arguments returning a tensor, called
when the leaf is copied to the host (so a caller can form one leaf's layout
at a time).  bfloat16 leaves are stored as the reference stores them: the
raw 16-bit patterns under an npy ``'<V2'`` header, ``"dtype": "bfloat16"``
in the index; they are read back through that dtype, so no numpy bfloat16
type is needed.  ``repro_torch.interop`` maps the port's training state
onto the reference's tree and back.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zipfile
from typing import Any

import numpy as np
import torch

from repro_torch.utils.logging import get_logger

log = get_logger("ckpt")

_META = "meta.json"
_SHARD_BYTES = 512 * 1024 * 1024  # flush arrays into <=512MB npz volumes
_BF16 = "bfloat16"


class _HostLeaf:
    """A leaf on the host: its bytes as a numpy array and the dtype name the
    index records (``bits`` holds uint16 patterns for bfloat16)."""

    __slots__ = ("bits", "dtype")

    def __init__(self, bits: np.ndarray, dtype: str):
        self.bits = bits
        self.dtype = dtype

    @property
    def shape(self) -> tuple:
        return self.bits.shape

    @property
    def nbytes(self) -> int:
        return self.bits.nbytes


def _is_record(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_flatten_with_paths(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """``(path, leaf)`` pairs in the reference's flatten order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif _is_record(tree):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += tree_flatten_with_paths(v, f"{prefix}/{k}" if prefix else k)
    return out


def _unflatten(target: Any, leaves) -> Any:
    """``target``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if target is None:
        return None
    if isinstance(target, dict):
        out = {k: _unflatten(target[k], leaves) for k in sorted(target)}
        return {k: out[k] for k in target}
    if _is_record(target):
        return type(target)(*[_unflatten(v, leaves) for v in target])
    if isinstance(target, (list, tuple)):
        return type(target)(_unflatten(v, leaves) for v in target)
    return next(leaves)


def _host(leaf: Any) -> _HostLeaf:
    if callable(leaf):
        leaf = leaf()
    if isinstance(leaf, _HostLeaf):
        return leaf
    if isinstance(leaf, torch.Tensor):
        # a copy even from the CPU (the state is trained in place), and
        # synchronous: it is complete when this returns
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return _HostLeaf(t.contiguous().view(torch.int16).numpy().view(np.uint16), _BF16)
        a = np.asarray(t.numpy(), order="C")  # 0-d stays 0-d, unlike ascontiguousarray
    else:
        a = np.array(leaf, order="C")
    if a.dtype.name == _BF16:  # a numpy bfloat16 array (ml_dtypes)
        return _HostLeaf(a.view(np.uint16), _BF16)
    return _HostLeaf(a, str(a.dtype))


def _to_host(tree: Any) -> list[tuple[str, _HostLeaf]]:
    return [(path, _host(leaf)) for path, leaf in tree_flatten_with_paths(tree)]


def _write_volume(path: str, arrays: dict[str, _HostLeaf]) -> None:
    """``np.savez`` of the volume, byte for byte; a bfloat16 leaf gets the
    header numpy writes for a bfloat16 array (descr ``'<V2'``)."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, leaf in arrays.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if leaf.dtype == _BF16:
                    np.lib.format.write_array_header_1_0(
                        fid, {"descr": "<V2", "fortran_order": False,
                              "shape": leaf.shape})
                    fid.write(leaf.bits.astype("<u2", copy=False).tobytes())
                else:
                    np.lib.format.write_array(fid, leaf.bits)


def _save_host(directory: str, flat: list[tuple[str, _HostLeaf]]) -> None:
    os.makedirs(directory, exist_ok=True)
    volumes: list[dict[str, _HostLeaf]] = [{}]
    vol_bytes = 0
    index: dict[str, dict] = {}
    for i, (path, leaf) in enumerate(flat):
        if vol_bytes > _SHARD_BYTES:
            volumes.append({})
            vol_bytes = 0
        key = f"a{i}"
        volumes[-1][key] = leaf
        vol_bytes += leaf.nbytes
        index[path] = {"volume": len(volumes) - 1, "key": key,
                       "shape": list(leaf.shape), "dtype": leaf.dtype}
    for v, arrs in enumerate(volumes):
        _write_volume(os.path.join(directory, f"vol{v}.npz"), arrs)
    with open(os.path.join(directory, _META), "w") as f:
        json.dump({"index": index, "num_volumes": len(volumes)}, f)


def save_pytree(directory: str, tree: Any) -> None:
    _save_host(directory, _to_host(tree))


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    arr = np.array(arr)  # np.load hands out read-only buffers
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _cast(t: torch.Tensor, ref: Any):
    """The loaded leaf in a tensor ``ref``'s dtype, on its device (the CPU
    for a meta tensor)."""
    if isinstance(ref, torch.Tensor):
        dev = torch.device("cpu") if ref.device.type == "meta" else ref.device
        return t.to(device=dev, dtype=ref.dtype)
    return t


def load_pytree(directory: str, target: Any | None = None) -> Any:
    """Load a tree as CPU tensors; with ``target``, each leaf is mapped into
    its structure by path (a tensor target leaf sets the dtype and device),
    otherwise a nested dict is returned."""
    with open(os.path.join(directory, _META)) as f:
        meta = json.load(f)
    vols = [np.load(os.path.join(directory, f"vol{v}.npz"))
            for v in range(meta["num_volumes"])]
    by_path = {path: _tensor(vols[info["volume"]][info["key"]], info["dtype"])
               for path, info in meta["index"].items()}
    if target is None:
        nested: dict = {}
        for path, arr in by_path.items():
            parts = path.split("/")
            node = nested
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = arr
        return nested
    flat_t = tree_flatten_with_paths(target)
    missing = [p for p, _ in flat_t if p not in by_path]
    if missing:
        raise KeyError(f"checkpoint missing leaves: {missing[:5]} "
                       f"(+{max(len(missing) - 5, 0)} more)")
    leaves = []
    for path, ref in flat_t:
        arr = by_path[path]
        shape = tuple(ref.shape) if isinstance(ref, torch.Tensor) else np.shape(ref)
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"shape mismatch at {path}: ckpt {tuple(arr.shape)} vs "
                             f"target {shape}")
        leaves.append(_cast(arr, ref))
    return _unflatten(target, iter(leaves))


class CheckpointManager:
    def __init__(self, root: str, keep: int = 3, async_save: bool = False):
        self.root = root
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        #: seconds of the last save's device -> host copy and of its writes
        #: (the writes of an async save are counted once ``wait`` returns)
        self.last_copy_s = 0.0
        self.last_write_s = 0.0
        os.makedirs(root, exist_ok=True)

    # -- paths ---------------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{step:010d}")

    def all_steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.root):
            if name.startswith("step_") and not name.startswith(".tmp"):
                try:
                    steps.append(int(name.split("_")[1]))
                except ValueError:
                    continue
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save / restore --------------------------------------------------------
    def save(self, step: int, state: dict[str, Any], extra: dict | None = None) -> None:
        """``state``: dict of trees.  ``extra``: JSON-serialisable host state
        (controller, cursor, python scalars)."""
        self.wait()  # one in-flight save at a time
        t0 = time.perf_counter()
        host = {k: _to_host(v) for k, v in state.items()}
        self.last_copy_s = time.perf_counter() - t0

        def _write():
            t1 = time.perf_counter()
            tmp = os.path.join(self.root, f".tmp.step_{step:010d}")
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            for k, flat in host.items():
                _save_host(os.path.join(tmp, k), flat)
            with open(os.path.join(tmp, "extra.json"), "w") as f:
                json.dump({"step": step, **(extra or {})}, f)
            final = self._step_dir(step)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()
            self.last_write_s = time.perf_counter() - t1
            log.info("saved checkpoint step=%d -> %s", step, final)

        if self.async_save:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()
        else:
            _write()

    def restore(self, targets: dict[str, Any], step: int | None = None,
                plan: Any | None = None) -> tuple[dict[str, Any], dict]:
        """Restore trees shaped like ``targets`` (CPU tensors, or each
        target leaf's device); with ``plan`` (a ``dist.ShardingPlan``), each
        tree is placed onto the plan's device via ``elastic.reshard.place``:
        checkpoints are topology-free."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        d = self._step_dir(step)
        out = {k: load_pytree(os.path.join(d, k), tgt) for k, tgt in targets.items()}
        if plan is not None:
            from repro_torch.elastic.reshard import place  # ckpt is a leaf layer

            out = {k: place(v, plan) for k, v in out.items()}
        with open(os.path.join(d, "extra.json")) as f:
            extra = json.load(f)
        return out, extra

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
