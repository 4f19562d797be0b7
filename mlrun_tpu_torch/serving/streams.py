"""Stream pushers for queue steps and monitoring events — the port's copy
of ``mlrun_tpu/serving/streams.py``: an in-memory stream (tests,
single-process serving), a file-backed JSONL stream (a durable local
monitoring pipeline), and Kafka, whose client is imported only when a
``kafka://`` path is pushed to.
"""

from __future__ import annotations

import json
import os
import threading
from collections import deque
from typing import Callable


class _InMemStream:
    def __init__(self, name: str, maxlen: int = 10000):
        self.name = name
        self._items: deque = deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self._subscribers: list[Callable] = []

    def push(self, data):
        if isinstance(data, list):
            items = data
        else:
            items = [data]
        with self._lock:
            for item in items:
                self._items.append(item)
                for callback in self._subscribers:
                    callback(item)

    def pull(self, max_items: int = 100) -> list:
        out = []
        with self._lock:
            while self._items and len(out) < max_items:
                out.append(self._items.popleft())
        return out

    def subscribe(self, callback: Callable):
        self._subscribers.append(callback)

    def __len__(self):
        return len(self._items)


_inmem_streams: dict[str, _InMemStream] = {}
_lock = threading.Lock()


def get_in_memory_stream(name: str) -> _InMemStream:
    with _lock:
        if name not in _inmem_streams:
            _inmem_streams[name] = _InMemStream(name)
        return _inmem_streams[name]


class _FileStream:
    """Durable jsonl stream: one file per stream, append-only."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._lock = threading.Lock()

    def push(self, data):
        items = data if isinstance(data, list) else [data]
        with self._lock, open(self.path, "a") as fp:
            for item in items:
                fp.write(json.dumps(item, default=str) + "\n")

    def pull(self, offset: int = 0, max_items: int = 0) -> tuple[list, int]:
        if not os.path.isfile(self.path):
            return [], offset
        out = []
        with open(self.path) as fp:
            fp.seek(offset)
            for line in fp:
                if line.strip():
                    out.append(json.loads(line))
                if max_items and len(out) >= max_items:
                    break
            offset = fp.tell()
        return out, offset


class _KafkaStream:
    def __init__(self, brokers: str, topic: str):
        from kafka import KafkaProducer  # gated import

        self._producer = KafkaProducer(bootstrap_servers=brokers.split(","))
        self.topic = topic

    def push(self, data):
        items = data if isinstance(data, list) else [data]
        for item in items:
            self._producer.send(
                self.topic, json.dumps(item, default=str).encode())


def get_stream_pusher(path: str, **options):
    """Resolve a stream path: memory://name, file:///path, kafka://brokers/topic."""
    if path.startswith("memory://"):
        return get_in_memory_stream(path[len("memory://"):])
    if path.startswith("kafka://"):
        body = path[len("kafka://"):]
        brokers, _, topic = body.partition("/")
        return _KafkaStream(options.get("brokers", brokers), topic)
    if path.startswith("file://"):
        return _FileStream(path[len("file://"):])
    # bare path → file stream
    return _FileStream(path)
