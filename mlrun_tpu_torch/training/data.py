"""Training data pipelines — counterpart of ``mlrun_tpu/training/data.py``.

``synthetic_token_stream`` and ``array_token_stream`` are copies: the same
seed yields the same numpy batches as the reference. Batches stay numpy on
the host; ``DevicePrefetchIterator`` moves them to the card ahead of the
step that consumes them. ``text_file_stream`` and ``TokenShardLoader``
(a tokenizer and ``native/``) are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import queue as queue_mod
import threading
from typing import Iterator

import numpy as np
import torch


def synthetic_token_stream(batch_size: int, seq_len: int, vocab_size: int,
                           seed: int = 0) -> Iterator[tuple]:
    """Deterministic synthetic LM batches: (tokens, targets)."""
    rng = np.random.default_rng(seed)
    while True:
        tokens = rng.integers(0, vocab_size, (batch_size, seq_len + 1),
                              dtype=np.int32)
        yield tokens[:, :-1], tokens[:, 1:]


def array_token_stream(token_array: np.ndarray, batch_size: int, seq_len: int,
                       shuffle: bool = True, seed: int = 0,
                       drop_last: bool = True) -> Iterator[tuple]:
    """Chunk a flat token array into LM batches, looping forever."""
    tokens = np.asarray(token_array, dtype=np.int32).reshape(-1)
    n_chunks = (len(tokens) - 1) // seq_len
    if n_chunks < 1:
        raise ValueError("token array shorter than one sequence")
    inputs = tokens[: n_chunks * seq_len].reshape(n_chunks, seq_len)
    targets = tokens[1: n_chunks * seq_len + 1].reshape(n_chunks, seq_len)
    rng = np.random.default_rng(seed)
    while True:
        order = rng.permutation(n_chunks) if shuffle else np.arange(n_chunks)
        for start in range(0, n_chunks - batch_size + 1, batch_size):
            idx = order[start: start + batch_size]
            yield inputs[idx], targets[idx]


def to_device(batch, device) -> tuple:
    """(tokens, targets) host arrays -> int32 tensors on ``device`` (a
    plain synchronous copy; the trainer's path without prefetch)."""
    return tuple(torch.as_tensor(np.asarray(a, dtype=np.int32)).to(device)
                 for a in batch)


class _PrefetchError:
    """Queue envelope carrying a producer-side exception to the consumer
    at the exact batch position it occurred."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


_PREFETCH_END = object()  # sentinel: upstream iterator exhausted


class DevicePrefetchIterator:
    """Bounded background device-prefetch stage for the training loop.

    A producer thread pulls host batches from ``stream``, copies each into
    a pinned host buffer and starts the host->device copy on a side CUDA
    stream, recording an event behind it; the staged (tokens, targets)
    int32 tensors wait in a queue of ``depth`` entries. ``__next__`` makes
    the consumer's current stream wait on that event (no host sync), so
    the step overlaps its compute with the next batch's host production
    and its H2D copy. For a CPU ``device`` the copy is a plain one.

    Contracts (the reference's):

    - **Order-preserving and deterministic** — one producer thread pulls
      sequentially; consumers see exactly the upstream batch sequence.
    - **Error-transparent** — a producer-side exception surfaces on the
      consumer at the position of the failing batch, not as a hang.
    - **Deadlock-free shutdown** — ``close()`` drains the queue while the
      producer may be blocked on a full one, so a preemption exit never
      waits on a prefetched batch nobody will consume.
    """

    def __init__(self, stream, device="cuda", depth: int = 2):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._iterator = iter(stream)
        self.device = torch.device(device)
        self.depth = depth
        self._cuda = self.device.type == "cuda"
        self._copy_stream = (torch.cuda.Stream(device=self.device)
                             if self._cuda else None)
        self._queue: queue_mod.Queue = queue_mod.Queue(maxsize=depth)
        self._closed = threading.Event()
        self._exhausted = False
        self._thread = threading.Thread(
            target=self._produce, daemon=True, name="mlt-device-prefetch")
        self._thread.start()

    # -- producer ------------------------------------------------------------
    def _place(self, item):
        host = [np.ascontiguousarray(a, dtype=np.int32) for a in item]
        if not self._cuda:
            return tuple(torch.from_numpy(a.copy()) for a in host), None
        # PyTorch's pinned-host allocator keeps a block out of reuse until
        # the copy reading it has completed, so the buffers can go here
        pinned = [torch.from_numpy(a).pin_memory() for a in host]
        with torch.cuda.stream(self._copy_stream):
            placed = tuple(t.to(self.device, non_blocking=True)
                           for t in pinned)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        return placed, ready

    def _put(self, item) -> bool:
        """Enqueue with close-awareness: never blocks indefinitely on a
        full queue (the consumer may have exited at a preemption point)."""
        while not self._closed.is_set():
            try:
                self._queue.put(item, timeout=0.05)
                return True
            except queue_mod.Full:
                continue
        return False

    def _produce(self):
        while not self._closed.is_set():
            try:
                batch = next(self._iterator)
            except StopIteration:
                self._put(_PREFETCH_END)
                return
            except BaseException as exc:  # noqa: BLE001 - delivered to
                # the consumer at this batch's position
                self._put(_PrefetchError(exc))
                return
            try:
                placed = self._place(batch)
            except BaseException as exc:  # noqa: BLE001
                self._put(_PrefetchError(exc))
                return
            if not self._put(placed):
                return

    # -- consumer ------------------------------------------------------------
    def __iter__(self):
        return self

    def __next__(self):
        if self._exhausted or self._closed.is_set():
            raise StopIteration
        while True:
            try:
                item = self._queue.get(timeout=0.05)
                break
            except queue_mod.Empty:
                if self._closed.is_set() or not self._thread.is_alive():
                    # a dead producer always leaves a sentinel/error
                    # behind — an empty queue here means close() raced us
                    if self._queue.empty():
                        raise StopIteration from None
        if item is _PREFETCH_END:
            self._exhausted = True
            raise StopIteration
        if isinstance(item, _PrefetchError):
            self._exhausted = True
            raise item.exc
        placed, ready = item
        if ready is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(ready)
            for tensor in placed:
                # the caching allocator must not hand these blocks out
                # again before the consumer stream is done with them
                tensor.record_stream(consumer)
        return placed

    # -- lifecycle -----------------------------------------------------------
    def close(self, timeout: float = 5.0):
        """Stop the producer and drop staged batches. Safe to call from
        the preemption/early-stop path with the queue full — the drain
        below is what unblocks a producer mid-``put``."""
        if self._closed.is_set():
            return
        self._closed.set()

        def _drain_queue():
            while True:
                try:
                    self._queue.get_nowait()
                except queue_mod.Empty:
                    return

        _drain_queue()
        self._thread.join(timeout)
        # a producer blocked in put() may have slipped one item into the
        # just-drained queue before observing the closed flag
        _drain_queue()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
