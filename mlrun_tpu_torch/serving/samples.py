"""Serving-side sample tap for the model-monitoring loop — the port's
copy of ``mlrun_tpu/serving/samples.py``.

The LLM engines complete many requests per second; a drift analyzer
needs a bounded, cheap view of that traffic — per-request output tokens,
lengths, latencies and a first-token logit margin — without the engines
importing any monitoring code. Same pattern as the chaos fire observer
(``chaos/registry.py``): an observer is pushed in from above, and the
engines pay ONE module-attribute check per completion while nothing is
armed (and copy no logits row to the host). Stdlib-only, importable below
every serving layer.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Optional

# observer(sample: dict) installed by the monitoring controller; None =
# dark (the engines skip even building the sample dict)
_observer: Optional[Callable[[dict], None]] = None


def sampling_enabled() -> bool:
    """The engines' fast-path gate: build a sample only when someone is
    listening (one module-attribute read when dark)."""
    return _observer is not None


def get_sample_observer() -> Optional[Callable[[dict], None]]:
    """The currently installed observer (an uninstaller must check it
    still owns the slot — see ContinuousTuningController.stop)."""
    return _observer


def set_sample_observer(observer: Optional[Callable[[dict], None]]):
    """Install (or clear, with None) the process-wide sample observer.
    The observer runs on engine scheduler threads — it must be cheap and
    never raise consequences into the engine (emit_sample swallows)."""
    global _observer
    _observer = observer


def emit_sample(**sample):
    """Hand one completed-request sample to the observer, if armed.
    Sample keys (engines fill what they cheaply have): ``adapter``,
    ``tokens`` (generated token ids), ``prompt_len``, ``generated``,
    ``ttft_s``, ``total_s``, ``logit_margin`` (first-token top1-top2
    logit gap, NaN when unavailable), ``engine``, ``replica``."""
    observer = _observer
    if observer is None:
        return
    try:
        observer(sample)
    except Exception:  # noqa: BLE001 - monitoring must never fail a
        pass           # request's completion path


class SampleRing:
    """Bounded thread-safe sample buffer: the default observer target.
    Engines append from scheduler threads; the monitoring controller
    drains on its tick. Overflow drops OLDEST (the analyzer wants the
    current window, not history) and is counted."""

    def __init__(self, maxlen: int = 4096):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(16, int(maxlen)))
        self.dropped = 0
        self.total = 0

    def append(self, sample: dict):
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(sample)
            self.total += 1

    def drain(self) -> list:
        with self._lock:
            out = list(self._ring)
            self._ring.clear()
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)
