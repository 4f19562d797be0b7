"""Black-box flight recorder — the port's own copy of
``mlrun_tpu/obs/flight.py``: a bounded, lock-cheap ring of structured
events (chaos fires, admissions, sheds, speculative parks, scheduler
crashes) that the engines append to, dumped as a JSONL post-mortem when a
scheduler dies and readable live through :meth:`FlightRecorder.events`.

- **Stdlib only**, below every other layer of the port.
- **Lock-cheap when recording**: one lock + deque append per event.
- **Bounded**: the ring holds the last N events (default 4096).
- **Dump never raises**: ``dump`` returns the artifact path or ``None``;
  without a path it writes under the configured directory
  (``configure(directory=)``, or ``config.OBSERVABILITY_DEFAULTS
  ["flight"]["dir"]`` through :func:`configure_from_mlconf`), else under
  the process temp directory (``tempfile.gettempdir()``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Optional

_DEFAULT_RING = 4096

# monotonically increasing per-process sequence so readers can order
# events even when two land inside one clock tick
_seq_lock = threading.Lock()
_seq = 0


def _next_seq() -> int:
    global _seq
    with _seq_lock:
        _seq += 1
        return _seq


class FlightRecorder:
    """Bounded ring of structured events. One process-wide instance
    (:func:`get_flight_recorder`); tests may build isolated ones."""

    def __init__(self, ring: int = _DEFAULT_RING):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(16, int(ring)))
        self._dir: Optional[str] = None
        self.dumps = 0                      # post-mortems written
        self.last_dump_path: Optional[str] = None

    # -- configuration -------------------------------------------------------
    def configure(self, ring: int | None = None, directory: str | None = None):
        if ring is not None:
            with self._lock:
                self._ring = deque(self._ring, maxlen=max(16, int(ring)))
        if directory is not None:
            self._dir = directory or None
        return self

    def _dump_dir(self) -> str:
        if self._dir:
            return self._dir
        import tempfile

        return os.path.join(tempfile.gettempdir(), "mlt-flight")

    # -- recording -----------------------------------------------------------
    def record(self, kind: str, **data) -> dict:
        """Append one structured event. Hot-path cheap: timestamp +
        sequence + one locked deque append; values should already be
        JSON-friendly scalars (the dump serializes with ``default=str``
        so a stray object degrades to its repr, never an error)."""
        event = {"t": time.time(), "seq": _next_seq(), "kind": kind}
        if data:
            event.update(data)
        with self._lock:
            self._ring.append(event)
        return event

    # -- reading -------------------------------------------------------------
    def events(self, kind: str | None = None, limit: int = 0) -> list[dict]:
        """Snapshot of the ring, oldest first; ``kind`` filters by exact
        event kind or a ``prefix.*`` wildcard, ``limit`` keeps only the
        newest N after filtering (0 = all)."""
        with self._lock:
            snapshot = list(self._ring)
        if kind:
            if kind.endswith(".*"):
                prefix = kind[:-1]
                snapshot = [e for e in snapshot
                            if e["kind"].startswith(prefix)]
            else:
                snapshot = [e for e in snapshot if e["kind"] == kind]
        if limit > 0:
            snapshot = snapshot[-limit:]
        return snapshot

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def clear(self):
        with self._lock:
            self._ring.clear()

    # -- post-mortem dump ----------------------------------------------------
    def dump(self, reason: str, path: str | None = None,
             extra: dict | None = None) -> Optional[str]:
        """Drain the ring into a JSONL artifact: one header object (the
        reason + event count), then one event per line, oldest first.
        Returns the artifact path, or ``None`` when nothing could be
        written — a failing post-mortem writer must never mask the
        failure being post-mortemed. The ring is NOT cleared: a second
        failure in the same process still sees the shared history."""
        events = self.events()
        try:
            if path is None:
                directory = self._dump_dir()
                os.makedirs(directory, exist_ok=True)
                safe = "".join(c if c.isalnum() or c in "-_" else "-"
                               for c in str(reason)) or "dump"
                path = os.path.join(
                    directory,
                    f"flight-{safe}-{int(time.time() * 1000)}"
                    f"-{os.getpid()}.jsonl")
            else:
                directory = os.path.dirname(path)
                if directory:
                    os.makedirs(directory, exist_ok=True)
            header = {"flight_dump": True, "reason": str(reason),
                      "t": time.time(), "events": len(events),
                      "pid": os.getpid()}
            if extra:
                header.update(extra)
            with open(path, "w") as fp:
                fp.write(json.dumps(header, default=str) + "\n")
                for event in events:
                    fp.write(json.dumps(event, default=str) + "\n")
        except Exception:  # noqa: BLE001 - never raise out of a post-mortem
            return None
        with self._lock:
            self.dumps += 1
            self.last_dump_path = path
        return path


# process-wide recorder: trainer, monitor, engines, breakers, chaos
_recorder = FlightRecorder()


def get_flight_recorder() -> FlightRecorder:
    return _recorder


def record(kind: str, **data) -> dict:
    """Module-level convenience for the one process-wide recorder."""
    return _recorder.record(kind, **data)


def configure_from_mlconf() -> FlightRecorder:
    """Apply ``config.OBSERVABILITY_DEFAULTS["flight"]`` (ring size, dump
    dir) to the process recorder; the config import is lazy so this
    module stays bottom-layer."""
    try:
        from ..config import OBSERVABILITY_DEFAULTS

        conf = OBSERVABILITY_DEFAULTS.get("flight")
        if conf is None:
            return _recorder
        ring = conf.get("ring")
        directory = str(conf.get("dir", "") or "")
        _recorder.configure(ring=int(ring) if ring else None,
                            directory=directory or None)
    except Exception:  # noqa: BLE001 - observability must not block startup
        pass
    return _recorder
