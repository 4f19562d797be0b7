"""Goodput/badput accounting of a training run — the port's copy of
``mlrun_tpu/obs/goodput.py`` (the in-process ledger, its four metric
families, and the service's out-of-band attribution: :func:`record_badput`
for the gaps the run process never sees, :func:`release_run` /
:func:`retire_run` for the series of finished runs).

:class:`GoodputLedger` attributes every wall-second of a ``Trainer.fit``
to goodput (the ``step`` phase) or a typed badput bucket. Entering a phase
closes the previous one at the same clock read, so the per-phase seconds
sum to the clock span by construction: ``goodput + sum(badput) == wall``.

Exported families (the reference's names and labels):

- ``mlt_goodput_seconds_total{run}`` — productive step seconds
- ``mlt_badput_seconds_total{run,bucket}`` — typed unproductive seconds
- ``mlt_goodput_wall_seconds_total{run}`` — total attributed seconds
- ``mlt_goodput_fraction{run}`` — goodput / wall
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable

from .metrics import REGISTRY

# the one productive phase; everything else is a badput bucket
GOODPUT_PHASE = "step"

# the reference's typed badput buckets (its docs/observability.md table)
BADPUT_BUCKETS = ("compile", "re_warm", "data_wait", "h2d", "metric_flush",
                  "checkpoint", "preemption_downtime", "resubmit_gap",
                  "stall", "reshard", "degraded", "init", "other")

# one admission gate bounds the ``run`` label across the four families,
# so a run gets the series of every family or of none
RUN_LABEL_BUDGET = 256

GOODPUT_SECONDS = REGISTRY.counter(
    "mlt_goodput_seconds_total",
    "Productive (train-step dispatch) wall seconds per run",
    labels=("run",), max_label_sets=512, overflow="drop")
BADPUT_SECONDS = REGISTRY.counter(
    "mlt_badput_seconds_total",
    "Unproductive wall seconds per run by typed bucket (compile, "
    "re_warm, data_wait, h2d, metric_flush, checkpoint, "
    "preemption_downtime, resubmit_gap, stall, reshard, degraded, "
    "init, other)",
    labels=("run", "bucket"), max_label_sets=8192, overflow="drop")
WALL_SECONDS = REGISTRY.counter(
    "mlt_goodput_wall_seconds_total",
    "Total attributed wall seconds per run (goodput + every badput "
    "bucket)",
    labels=("run",), max_label_sets=512, overflow="drop")
GOODPUT_FRACTION = REGISTRY.gauge(
    "mlt_goodput_fraction",
    "goodput seconds / attributed wall seconds per run",
    labels=("run",), max_label_sets=512, overflow="drop")

_admit_lock = threading.Lock()
_admitted_runs: set = set()


def _admit_run(run: str) -> bool:
    """Atomic cross-family admission for a ``run`` label value; ``""``
    (the anonymous shared series) is always admitted."""
    if not run:
        return True
    with _admit_lock:
        if run in _admitted_runs:
            return True
        if len(_admitted_runs) >= RUN_LABEL_BUDGET:
            return False
        _admitted_runs.add(run)
        return True


def retire_run(run: str):
    """Drop a run's per-run series from every goodput family — the same
    series-lifecycle contract fleet replicas and adapters follow: a
    long-lived service attributing badput for a rotating run population
    must not consume the families' label-set budget forever (past it,
    ``overflow="drop"`` silently stops attributing NEW runs)."""
    if not run:
        return  # "" is the shared anonymous series, never retired
    GOODPUT_SECONDS.remove(run=run)
    WALL_SECONDS.remove(run=run)
    GOODPUT_FRACTION.remove(run=run)
    for bucket in BADPUT_BUCKETS:
        BADPUT_SECONDS.remove(run=run, bucket=bucket)
    with _admit_lock:
        _admitted_runs.discard(run)


# finished runs whose series are KEPT so the terminal attribution (the
# stall window, the final fraction) survives until federation scrapes
# it; past the bound the oldest retires — bounded well inside the
# families' label-set budgets
RECENT_RUNS_KEPT = 64
_recent_lock = threading.Lock()
_recent_runs: list[str] = []


def release_run(run: str):
    """Queue a finished run for series retirement (the monitor calls
    this when it forgets a run's resource). The most recent
    ``RECENT_RUNS_KEPT`` finished runs stay scrapeable; older ones are
    retired via :func:`retire_run`."""
    if not run:
        return
    evicted = []
    with _recent_lock:
        if run in _recent_runs:
            _recent_runs.remove(run)
        _recent_runs.append(run)
        while len(_recent_runs) > RECENT_RUNS_KEPT:
            evicted.append(_recent_runs.pop(0))
    for old in evicted:
        retire_run(old)


def record_badput(bucket: str, seconds: float, run: str = ""):
    """Out-of-band badput attribution (service-side lifecycle gaps the
    run process cannot time itself: retry backoff, preemption downtime,
    stall windows). Also advances the wall denominator so the
    goodput-fraction burn rate sees the downtime."""
    seconds = float(seconds)
    if seconds <= 0 or not _admit_run(run):
        return
    BADPUT_SECONDS.inc(seconds, run=run, bucket=bucket)
    WALL_SECONDS.inc(seconds, run=run)


class GoodputLedger:
    """Per-run step-phase ledger. The owner calls :meth:`enter` at every
    phase boundary; the clock time since the previous boundary goes to
    the phase being LEFT. ``clock`` is injectable (fake-clock tests); all
    methods are single-owner (the training loop) except
    :meth:`attribute`, which is thread-safe."""

    def __init__(self, run: str = "",
                 clock: Callable[[], float] = time.monotonic):
        self.run = run
        self._clock = clock
        self._lock = threading.Lock()
        now = clock()
        self._t0 = now
        self._t_last = now
        self._phase = "init"
        self._seconds: dict[str, float] = {}
        self._out_of_band = 0.0   # attribute() seconds (not in the span)
        self._exported: dict[str, float] = {}
        self._closed = False

    @property
    def current_phase(self) -> str:
        return self._phase

    def enter(self, phase: str) -> float:
        """Close the current phase at this instant and start ``phase``.
        Returns the seconds attributed to the phase being left."""
        now = self._clock()
        with self._lock:
            elapsed = max(0.0, now - self._t_last)
            if elapsed:
                self._seconds[self._phase] = \
                    self._seconds.get(self._phase, 0.0) + elapsed
            self._t_last = now
            self._phase = phase
        return elapsed

    @contextlib.contextmanager
    def phase(self, phase: str):
        """Scoped phase: enter ``phase``, and on exit return to the phase
        that was active before."""
        previous = self._phase
        self.enter(phase)
        try:
            yield self
        finally:
            self.enter(previous)

    def attribute(self, phase: str, seconds: float):
        """Add out-of-band seconds to ``phase`` (a warmup that ran before
        this ledger's window); the wall total grows with them."""
        seconds = float(seconds)
        if seconds <= 0:
            return
        with self._lock:
            self._seconds[phase] = self._seconds.get(phase, 0.0) + seconds
            self._out_of_band += seconds

    def transfer(self, src: str, dst: str, seconds: float):
        """Reclassify seconds already attributed to ``src`` into ``dst``,
        clamped to what ``src`` holds (wall stays invariant)."""
        with self._lock:
            available = self._seconds.get(src, 0.0)
            moved = max(0.0, min(float(seconds), available))
            if not moved:
                return
            self._seconds[src] = available - moved
            self._seconds[dst] = self._seconds.get(dst, 0.0) + moved

    def close(self, final_phase: str | None = None) -> dict:
        """Attribute the trailing open interval (to ``final_phase`` when
        given, else the current phase), export, and return the summary.
        Idempotent."""
        if not self._closed:
            if final_phase is not None:
                with self._lock:
                    self._phase = final_phase
            self.enter(self._phase)
            self._closed = True
        self.export()
        return self.summary()

    def wall_seconds(self) -> float:
        """Attributed wall so far: the clock span (the open interval
        included) plus out-of-band additions."""
        with self._lock:
            span = max(0.0, self._clock() - self._t0) \
                if not self._closed else \
                sum(self._seconds.values()) - self._out_of_band
            return span + self._out_of_band

    def goodput_seconds(self) -> float:
        with self._lock:
            return self._seconds.get(GOODPUT_PHASE, 0.0)

    def badput(self) -> dict[str, float]:
        with self._lock:
            return {phase: seconds
                    for phase, seconds in sorted(self._seconds.items())
                    if phase != GOODPUT_PHASE and seconds > 0}

    def goodput_fraction(self) -> float:
        wall = self.wall_seconds()
        return (self.goodput_seconds() / wall) if wall > 0 else 0.0

    def summary(self) -> dict:
        with self._lock:
            attributed = dict(self._seconds)
        goodput = attributed.pop(GOODPUT_PHASE, 0.0)
        return {
            "run": self.run,
            "wall_s": self.wall_seconds(),
            "goodput_s": goodput,
            "goodput_fraction": self.goodput_fraction(),
            "badput": {k: v for k, v in sorted(attributed.items()) if v > 0},
            "badput_s": sum(attributed.values()),
        }

    def export(self):
        """Flush attribution deltas since the last export onto the
        counters and refresh the fraction gauge (counters only advance)."""
        if not _admit_run(self.run):
            return
        with self._lock:
            snapshot = dict(self._seconds)
        total = 0.0
        for phase, seconds in snapshot.items():
            delta = seconds - self._exported.get(phase, 0.0)
            if delta <= 0:
                continue
            self._exported[phase] = seconds
            total += delta
            if phase == GOODPUT_PHASE:
                GOODPUT_SECONDS.inc(delta, run=self.run)
            else:
                bucket = phase if phase in BADPUT_BUCKETS else "other"
                BADPUT_SECONDS.inc(delta, run=self.run, bucket=bucket)
        if total > 0:
            WALL_SECONDS.inc(total, run=self.run)
        GOODPUT_FRACTION.set(self.goodput_fraction(), run=self.run)
