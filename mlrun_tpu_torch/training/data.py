"""Training data pipelines — counterpart of ``mlrun_tpu/training/data.py``.

``synthetic_token_stream``, ``array_token_stream`` and ``text_file_stream``
are copies: the same seed yields the same numpy batches as the reference.
``TokenShardLoader`` drives the port's own copy of the native loader
(``csrc/data_loader.cpp``, built with ``g++`` at first use by
``ops/_build.build_host``), batch for batch the reference's for the same
shards and seed. Batches stay numpy on the host; ``DevicePrefetchIterator``
(or the synchronous :func:`device_prefetch`) moves them to the card ahead
of the step that consumes them.
"""

from __future__ import annotations

import queue as queue_mod
import threading
from typing import Iterator

import numpy as np
import torch

from ..chaos import FaultPoints, fire


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


def text_file_stream(path: str, tokenizer, batch_size: int, seq_len: int,
                     **kwargs) -> Iterator[tuple]:
    """Tokenize a text file with an HF tokenizer into an LM stream."""
    with open(path) as fp:
        text = fp.read()
    ids = np.asarray(tokenizer(text)["input_ids"], dtype=np.int32)
    return array_token_stream(ids, batch_size, seq_len, **kwargs)


# -- native token-shard loader (csrc/data_loader.cpp) -------------------------

def _native_lib_path() -> str:
    """``MLT_DATA_LOADER_LIB`` when set, else the port's loader library,
    built from ``csrc/data_loader.cpp`` on first use."""
    import os

    env = os.environ.get("MLT_DATA_LOADER_LIB")
    if env:
        return env
    from ..ops import _build

    return str(_build.build_host(_build.CSRC / "data_loader.cpp",
                                 "libmlt_data.so"))


class TokenShardLoader:
    """Native prefetching loader over flat token-shard files (the
    reference's, on the port's copy of its C++ source).

    Shards are mmapped read-only; worker threads cut seeded-shuffled
    (seq+1)-token windows and stage whole batches in a bounded ring
    buffer. Each batch lands by one memcpy in a reused host buffer
    (pinned when CUDA is available, so its copy to the card can run
    asynchronously) and is yielded as (tokens, targets) int32 numpy
    arrays, like ``synthetic_token_stream``; ``DevicePrefetchIterator``
    or :func:`device_prefetch` put them on the card ahead of the step.

    Shard format: little-endian flat token files, int32 (dtype="int32")
    or uint16 (dtype="uint16") — the usual pretokenized .bin layout.
    ``lib_path`` (or ``MLT_DATA_LOADER_LIB``) names another build of the
    same C interface.
    """

    def __init__(self, paths, batch_size: int, seq_len: int,
                 dtype: str = "int32", seed: int = 0, workers: int = 2,
                 queue_depth: int = 4, lib_path: str = ""):
        import ctypes
        import os

        if isinstance(paths, (str, bytes)):
            paths = [paths]
        self.paths = [str(p) for p in paths]
        for p in self.paths:
            if not os.path.isfile(p):
                raise FileNotFoundError(p)
        self.batch_size = batch_size
        self.seq_len = seq_len
        code = {"int32": 4, "uint16": 2}.get(dtype)
        if code is None:
            raise ValueError(f"dtype must be int32|uint16, got {dtype}")

        lib_path = lib_path or _native_lib_path()
        self._lib = ctypes.CDLL(lib_path)
        self._lib.mlt_loader_open.restype = ctypes.c_uint64
        self._lib.mlt_loader_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_uint32,
            ctypes.c_int, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32]
        self._lib.mlt_loader_next.restype = ctypes.c_int
        self._lib.mlt_loader_next.argtypes = [
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_int32)]
        self._lib.mlt_loader_total_tokens.restype = ctypes.c_uint64
        self._lib.mlt_loader_total_tokens.argtypes = [ctypes.c_uint64]
        self._lib.mlt_loader_epoch.restype = ctypes.c_uint64
        self._lib.mlt_loader_epoch.argtypes = [ctypes.c_uint64]
        self._lib.mlt_loader_close.argtypes = [ctypes.c_uint64]
        try:
            self._lib.mlt_loader_stats.restype = ctypes.c_int
            self._lib.mlt_loader_stats.argtypes = [
                ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64)]
            self._has_stats = True
        except AttributeError:
            # an older library without the stats export still loads
            self._has_stats = False

        arr = (ctypes.c_char_p * len(self.paths))(
            *[p.encode() for p in self.paths])
        self._handle = self._lib.mlt_loader_open(
            arr, len(self.paths), code, batch_size, seq_len, seed,
            workers, queue_depth)
        if not self._handle:
            raise RuntimeError(
                f"mlt_loader_open failed for {self.paths} (empty shards, "
                f"bad dtype, or shards shorter than seq_len+1)")
        self._host = torch.empty((batch_size, seq_len + 1),
                                 dtype=torch.int32,
                                 pin_memory=torch.cuda.is_available())
        self._buf = self._host.numpy()
        self._obs_name = (f"{os.path.basename(self.paths[0])}"
                          f"@{self._handle}")
        self._metrics_registered = False
        self._register_metrics()

    @property
    def total_tokens(self) -> int:
        return int(self._lib.mlt_loader_total_tokens(self._handle))

    @property
    def epoch(self) -> int:
        return int(self._lib.mlt_loader_epoch(self._handle))

    def stats(self) -> dict:
        """Ring occupancy and wait counters from the native side (the
        reference's keys). ``consumer_waits`` climbing while
        ``ring_occupancy`` sits at 0 is the input-bound signature; the
        same keys surface on ``/metrics`` through the registry
        collector."""
        import ctypes

        out = {"queue_depth": 0, "ring_occupancy": 0, "batches": 0,
               "consumer_waits": 0, "producer_waits": 0}
        if self._handle and self._has_stats:
            raw = (ctypes.c_uint64 * 5)()
            if self._lib.mlt_loader_stats(self._handle, raw):
                out.update(ring_occupancy=int(raw[0]),
                           queue_depth=int(raw[1]), batches=int(raw[2]),
                           consumer_waits=int(raw[3]),
                           producer_waits=int(raw[4]))
        out["epochs"] = int(self.epoch) if self._handle else 0
        return out

    # cumulative stats() keys mirrored as counter series at scrape time
    _COUNTER_STATS = ("batches", "consumer_waits", "producer_waits",
                      "epochs")

    def _register_metrics(self):
        """Expose the ring on the port's registry: a weakly bound
        scrape-time collector that retires itself (and removes its
        series) once the loader is closed or collected."""
        if self._metrics_registered:
            return
        import weakref

        try:
            from ..obs import (
                REGISTRY,
                TRAIN_LOADER_EVENTS,
                TRAIN_LOADER_OCCUPANCY,
            )
        except Exception:  # noqa: BLE001 - telemetry must never block IO
            return
        ref = weakref.ref(self)
        name = self._obs_name
        counter_stats = self._COUNTER_STATS

        def remove_series():
            TRAIN_LOADER_OCCUPANCY.remove(loader=name)
            for key in counter_stats:
                TRAIN_LOADER_EVENTS.remove(loader=name, event=key)

        def collect():
            loader = ref()
            if loader is None or not loader._handle:
                remove_series()
                return False
            stats = loader.stats()
            TRAIN_LOADER_OCCUPANCY.set(stats["ring_occupancy"], loader=name)
            for key in counter_stats:
                TRAIN_LOADER_EVENTS.set_total(stats[key], loader=name,
                                              event=key)
            return None

        REGISTRY.add_collector(collect)
        self._metrics_registered = True

    def __iter__(self):
        return self

    def __next__(self) -> tuple:
        import ctypes

        ok = self._lib.mlt_loader_next(
            self._handle,
            self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if not ok:
            raise StopIteration
        tokens = self._buf[:, :-1].copy()
        targets = self._buf[:, 1:].copy()
        return tokens, targets

    def close(self):
        if getattr(self, "_handle", 0):
            self._lib.mlt_loader_close(self._handle)
            self._handle = 0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 - interpreter teardown
            pass


def device_prefetch(stream, device="cuda", depth: int = 2):
    """Wrap a (tokens, targets) host iterator with device-side prefetch:
    keeps ``depth`` batches already on their way to ``device`` (int32
    tensors, copied from pinned memory without blocking the host on a
    CUDA device), so the train step never waits on host->device copies.
    The reference's ``sharding=`` (a jax placement) is ``device`` here.

    Synchronous variant: the copies are *issued* ahead, but the host
    batch for slot k+depth is still pulled on the consumer thread
    between steps. ``DevicePrefetchIterator`` moves that pull (and the
    copy) onto a background thread — ``Trainer.fit`` uses it."""
    import collections

    device = torch.device(device)
    queue = collections.deque()

    def put(item):
        host = [np.ascontiguousarray(a, dtype=np.int32) for a in item]
        if device.type != "cuda":
            return tuple(torch.from_numpy(a.copy()).to(device) for a in host)
        return tuple(torch.from_numpy(a).pin_memory().to(
            device, non_blocking=True) for a in host)

    iterator = iter(stream)
    try:
        for _ in range(depth):
            queue.append(put(next(iterator)))
    except StopIteration:
        pass
    while queue:
        out = queue.popleft()
        try:
            queue.append(put(next(iterator)))
        except StopIteration:
            pass
        yield out


def to_device(batch, device) -> tuple:
    """(tokens, targets) host arrays -> int32 tensors on ``device`` (a
    plain synchronous copy; the trainer's path without prefetch). Tensors
    already placed there pass through."""
    return tuple(a.to(device=device, dtype=torch.int32)
                 if isinstance(a, torch.Tensor) else
                 torch.as_tensor(np.asarray(a, dtype=np.int32)).to(device)
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
        self._h2d_bytes = 0   # batch bytes staged to the device so far
        self._closed = threading.Event()
        self._exhausted = False
        self._thread = threading.Thread(
            target=self._produce, daemon=True, name="mlt-device-prefetch")
        self._thread.start()

    # -- producer ------------------------------------------------------------
    def _place(self, item):
        host = [np.ascontiguousarray(a, dtype=np.int32) for a in item]
        self._h2d_bytes += sum(a.nbytes for a in host)
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
        index = 0
        while not self._closed.is_set():
            try:
                fire(FaultPoints.train_prefetch, batch_index=index)
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
            index += 1

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

    def stats(self) -> dict:
        """``h2d_bytes``: batch bytes staged to the device so far."""
        return {"h2d_bytes": self._h2d_bytes}

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
