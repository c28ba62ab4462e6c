"""Epoch-oriented, resumable batch pipeline.

Counterpart of ``repro/data/pipeline.py``; ``Cursor``, ``epoch_permutation``,
``EpochLoader`` and ``microbatches`` are numpy and copied as they are, so
both packages visit the same samples in the same order:

  * the batch size changes at adaptation boundaries (epoch ends, or — via
    ``repro_torch.adapt`` — mid-epoch ticks/events): an iterator is
    constructed per (epoch, batch-size) segment, and ``start_sample`` lets a
    mid-epoch resize continue the SAME epoch permutation at the exact sample
    offset the previous size stopped at;
  * determinism under restart: the permutation is a pure function of
    (seed, epoch), and the cursor (epoch, batch_index, sample_index) is
    checkpointable, so a resumed job sees the identical remaining batches.

``put_global_batch`` puts a host batch on a device (pinned and
``non_blocking`` on a card).  ``prefetch`` keeps ``depth`` batches in
flight ahead of the consumer; given a CUDA ``stream`` it runs the copies
there, and the consumer's stream waits on an event recorded after each
batch's copy, with ``record_stream`` keeping the tensors alive for it.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Iterator

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.data.synthetic import ArrayDataset


@dataclasses.dataclass
class Cursor:
    """Checkpointable position in the sample stream.

    ``sample_index`` is the number of samples consumed from the current
    epoch's permutation — the unit that stays meaningful when the batch size
    changes MID-epoch (``batch_index`` alone cannot say where the epoch is
    once steps have had different sizes).  Zero at every epoch boundary;
    pre-redesign checkpoints without the field load as zero.
    """

    epoch: int = 0
    batch_index: int = 0
    sample_index: int = 0

    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "batch_index": self.batch_index,
                "sample_index": self.sample_index}

    def load_state_dict(self, d: dict) -> None:
        self.epoch, self.batch_index = int(d["epoch"]), int(d["batch_index"])
        self.sample_index = int(d.get("sample_index", 0))


def epoch_permutation(n: int, seed: int, epoch: int) -> np.ndarray:
    return np.random.default_rng((seed, epoch)).permutation(n)


class EpochLoader:
    """Iterates one epoch of ``dataset`` at a fixed global batch size.

    drop_remainder=True keeps every step shape-identical (required for the
    bucketed compile cache); the tail (< batch_size samples) rolls over by
    virtue of reshuffling next epoch — same convention as the paper's code.
    """

    def __init__(
        self,
        dataset: ArrayDataset,
        batch_size: int,
        epoch: int,
        seed: int = 0,
        start_batch: int = 0,
        drop_remainder: bool = True,
        shard_index: int = 0,
        shard_count: int = 1,
        start_sample: int | None = None,
        perm: np.ndarray | None = None,
    ):
        """``start_sample`` resumes the epoch's permutation at an arbitrary
        sample offset — the unit a MID-epoch batch-size change needs (the
        new loader continues the identical permutation exactly where the old
        size stopped).  Default: ``start_batch * batch_size``, the classic
        batch-aligned resume.

        ``perm`` supplies the epoch permutation precomputed (must equal
        ``epoch_permutation(len(dataset), seed, epoch)``): a caller opening
        several loaders for one epoch (one per mid-epoch resize segment)
        avoids re-running the O(n) shuffle per segment."""
        if batch_size % shard_count != 0:
            raise ValueError(
                f"global batch {batch_size} not divisible by shard_count {shard_count}"
            )
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.epoch = int(epoch)
        self.seed = int(seed)
        self.start_batch = int(start_batch)
        self.shard_index = int(shard_index)
        self.shard_count = int(shard_count)
        n = len(dataset)
        self.start_sample = (
            int(start_sample) if start_sample is not None
            else self.start_batch * self.batch_size
        )
        remaining = max(n - self.start_sample, 0)
        self.num_batches = (
            remaining // batch_size if drop_remainder else -(-remaining // batch_size)
        )
        self._perm = perm if perm is not None else epoch_permutation(n, seed, epoch)

    def __len__(self) -> int:
        return self.num_batches

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        per_shard = self.batch_size // self.shard_count
        for b in range(self.num_batches):
            lo = self.start_sample + b * self.batch_size + self.shard_index * per_shard
            idx = self._perm[lo : lo + per_shard]
            yield self.dataset.get(idx)


def put_global_batch(batch: dict[str, np.ndarray],
                     device: torch.device | str | None = None) -> dict[str, torch.Tensor]:
    """Tensors of a host batch on ``device`` (None: the default device, the
    card).  On a card the host arrays are pinned and copied ``non_blocking``
    on the current stream."""
    dev = resolve_device() if device is None else resolve_device(device)
    if dev.type != "cuda":
        return {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
            .to(dev, non_blocking=True) for k, v in batch.items()}


def prefetch(batches, put=put_global_batch, *, depth: int = 2,
             host_overlap: bool = False, stream=None):
    """Double-buffered device feed: ``put`` (the device transfer) of batch
    *b+1* is issued while step *b* runs.

    ``depth`` batches are put ahead of the consumer; ``depth=1`` degenerates
    to the unbuffered ``put``-per-iteration loop.  The yielded values (and
    so the training trajectory) are the same either way, only the transfer
    timing moves.  ``stream`` (a ``torch.cuda.Stream``) runs the puts on a
    side stream so the copies overlap the steps; each yielded batch is
    safe to use on the consumer's current stream.

    ``host_overlap=True`` additionally moves the HOST side of producing a
    batch — the numpy gather inside ``batches`` — onto a background thread.
    The yielded sequence is identical (one producer, FIFO queue of the same
    ``depth``); closing the generator early (e.g. a mid-epoch resize
    abandoning the feed) stops the producer thread.
    """
    if depth < 1:
        raise ValueError(f"prefetch depth must be >= 1, got {depth}")
    staged = _staged_put(put, stream)
    if host_overlap:
        return _ready(_threaded_prefetch(batches, staged, depth))
    return _ready(_dispatch_prefetch(batches, staged, depth))


def _staged_put(put, stream):
    """``put`` returning ``(batch, event)``: on a side stream the event is
    recorded there after the copies (None without a stream)."""
    if stream is None:
        return lambda b: (put(b), None)

    def run(b):
        with torch.cuda.stream(stream):
            out = put(b)
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    return run


def _ready(items):
    """Yield each staged batch once the consumer's stream may use it."""
    try:
        for batch, event in items:
            if event is not None:
                current = torch.cuda.current_stream()
                current.wait_event(event)
                for t in batch.values():
                    t.record_stream(current)
            yield batch
    finally:
        close = getattr(items, "close", None)
        if close is not None:
            close()


def _dispatch_prefetch(batches, put, depth: int):
    buf: collections.deque = collections.deque()
    for b in batches:
        buf.append(put(b))
        if len(buf) >= depth:
            yield buf.popleft()
    while buf:
        yield buf.popleft()


def _threaded_prefetch(batches, put, depth: int):
    """Producer thread runs gather (iterating ``batches``) AND ``put``;
    consumer drains a bounded FIFO.  Exceptions propagate; early close of
    the generator stops the producer."""
    import queue
    import threading

    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    done = object()  # sentinel
    error: list[BaseException] = []

    def _offer(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for b in batches:
                if stop.is_set() or not _offer(put(b)):
                    return
        except BaseException as e:  # surfaced on the consumer side
            error.append(e)
        finally:
            _offer(done)

    thread = threading.Thread(target=producer, daemon=True, name="prefetch")
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                if error:
                    raise error[0]
                return
            yield item
    finally:
        stop.set()
        while not q.empty():  # unblock a producer stuck on a full queue
            try:
                q.get_nowait()
            except queue.Empty:
                break
        thread.join(timeout=10)


def microbatches(batch: dict[str, np.ndarray], micro_size: int):
    """Split a (host-side) batch into microbatches along axis 0."""
    n = len(next(iter(batch.values())))
    if n % micro_size != 0:
        raise ValueError(f"batch {n} not divisible by microbatch {micro_size}")
    for i in range(0, n, micro_size):
        yield {k: v[i : i + micro_size] for k, v in batch.items()}
