"""Bounded fixed-resolution time-series store over aggregated metrics —
the port's own copy of ``mlrun_tpu/obs/timeseries.py`` (same rings,
bucketing, counter-reset convention and quantile interpolation, so the
same samples answer the same windowed reads in both packages).

The federation layer (``obs/federation.py``) answers "what is the fleet
doing now"; SLO burn rates and the autoscaler need "what happened over
the last N minutes". This store is the smallest structure that answers
both windowed questions deterministically:

- one bounded ring per series at a fixed resolution (a sample lands in
  bucket ``floor(ts / resolution)``; the last write within a bucket
  wins; retention = ``resolution * capacity``, O(1) memory a series);
- counter-aware ``rate()`` / ``increase()`` (sums positive deltas,
  treats a reset as the post-reset value — the Prometheus convention);
- histogram-cumulative -> quantile: ``quantile()`` merges windowed bucket
  increases across label sets (the fleet-wide p95 over every replica's
  TTFT histogram) and interpolates linearly inside the winning bucket;
- the grafana simpleJSON target grammar and query (:func:`parse_target`,
  :func:`grafana_query`). The HTTP proxy that serves them belongs to the
  service (ROADMAP.md, item 14).

Stdlib only at module level; ``from_mlconf`` lazy-imports the config.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Optional

_TARGET_RE = re.compile(
    r"^(?:(?P<fn>rate|p50|p90|p95|p99)\()?"
    r"(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"(?(fn)\))"
    r"(?:\[(?P<window>[0-9]+(?:\.[0-9]+)?)\])?$")
_TARGET_LABEL_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"')

_QUANTILE_FNS = {"p50": 0.50, "p90": 0.90, "p95": 0.95, "p99": 0.99}


class _Ring:
    """Fixed-resolution circular buffer: slot i holds the value for
    bucket index ``head - (capacity - 1 - offset)``; ``None`` = no
    sample landed in that bucket."""

    __slots__ = ("values", "head", "kind")

    def __init__(self, capacity: int, kind: str):
        self.values: list = [None] * capacity
        self.head: Optional[int] = None  # newest bucket index
        self.kind = kind

    def put(self, bucket: int, value: float):
        capacity = len(self.values)
        if self.head is None:
            self.head = bucket
        elif bucket > self.head:
            # clear the buckets we skipped so stale values from a prior
            # lap never masquerade as fresh samples
            for skipped in range(self.head + 1, min(bucket,
                                                    self.head + capacity)):
                self.values[skipped % capacity] = None
            if bucket - self.head >= capacity:
                self.values = [None] * capacity
            self.head = bucket
        elif self.head - bucket >= capacity:
            return  # older than the ring's retention — drop
        self.values[bucket % capacity] = value

    def points(self, start_bucket: int, end_bucket: int):
        """``[(bucket, value)]`` for non-empty buckets in range."""
        if self.head is None:
            return []
        capacity = len(self.values)
        lo = max(start_bucket, self.head - capacity + 1)
        hi = min(end_bucket, self.head)
        out = []
        for bucket in range(lo, hi + 1):
            value = self.values[bucket % capacity]
            if value is not None:
                out.append((bucket, value))
        return out


class TimeSeriesStore:
    """Bounded store of ``(family, labels) → ring``; all reads take an
    explicit ``at`` so windows are deterministic in tests."""

    def __init__(self, resolution_s: float = 5.0, capacity: int = 720,
                 max_series: int = 2048):
        if resolution_s <= 0 or capacity <= 0 or max_series <= 0:
            raise ValueError("resolution_s, capacity, max_series must "
                             "be > 0")
        self.resolution_s = float(resolution_s)
        self.capacity = int(capacity)
        self.max_series = int(max_series)
        self.dropped_series = 0
        self._lock = threading.Lock()
        self._series: dict[tuple, _Ring] = {}

    @classmethod
    def from_mlconf(cls, **overrides) -> "TimeSeriesStore":
        """A store on ``config.OBSERVABILITY_DEFAULTS["timeseries"]``,
        with keyword overrides."""
        from ..config import OBSERVABILITY_DEFAULTS

        ts = OBSERVABILITY_DEFAULTS["timeseries"]
        kwargs = {"resolution_s": float(ts["resolution_s"]),
                  "capacity": int(ts["capacity"]),
                  "max_series": int(ts["max_series"])}
        kwargs.update(overrides)
        return cls(**kwargs)

    # -- writes --------------------------------------------------------------
    def _bucket(self, ts: float) -> int:
        return int(ts // self.resolution_s)

    def record(self, name: str, value: float, at: float,
               labels: Optional[dict] = None, kind: str = "gauge"):
        key = (name, frozenset(
            (k, str(v)) for k, v in (labels or {}).items()))
        with self._lock:
            ring = self._series.get(key)
            if ring is None:
                if len(self._series) >= self.max_series:
                    self.dropped_series += 1
                    return
                ring = _Ring(self.capacity, kind)
                self._series[key] = ring
            ring.put(self._bucket(at), float(value))

    def drop_series(self, name: Optional[str] = None,
                    labels: Optional[dict] = None):
        """Remove series matching name (+ label subset); ``name=None``
        matches every family — the scale-down path retires a removed
        replica's series across all of them so a churning fleet cannot
        fill ``max_series`` with dead rings."""
        match = set(((k, str(v)) for k, v in (labels or {}).items()))
        with self._lock:
            for key in [k for k in self._series
                        if (name is None or k[0] == name)
                        and match <= set(k[1])]:
                del self._series[key]

    # -- reads ---------------------------------------------------------------
    def _select(self, name: str, labels: Optional[dict] = None):
        match = set(((k, str(v)) for k, v in (labels or {}).items()))
        with self._lock:
            return [(key[1], ring) for key, ring in self._series.items()
                    if key[0] == name and match <= set(key[1])]

    def series(self) -> list[dict]:
        with self._lock:
            return [{"name": name, "labels": dict(labels)}
                    for name, labels in sorted(
                        self._series, key=lambda k: (k[0], sorted(k[1])))]

    def search(self, query: str = "") -> list[str]:
        """Series descriptors (``name{k="v",...}``) matching a substring
        — the grafana ``/search`` payload."""
        out = []
        for entry in self.series():
            labels = ",".join(f'{k}="{v}"' for k, v in
                              sorted(entry["labels"].items()))
            desc = entry["name"] + (f"{{{labels}}}" if labels else "")
            if query.lower() in desc.lower():
                out.append(desc)
        return out

    def points(self, name: str, start: float, end: float,
               labels: Optional[dict] = None, agg: str = "sum"):
        """Bucket-aligned ``[(ts, value)]`` over matching series,
        aggregated per bucket (``sum``/``max``/``avg``)."""
        per_bucket: dict[int, list] = {}
        for _, ring in self._select(name, labels):
            for bucket, value in ring.points(self._bucket(start),
                                             self._bucket(end)):
                per_bucket.setdefault(bucket, []).append(value)
        out = []
        for bucket in sorted(per_bucket):
            values = per_bucket[bucket]
            if agg == "max":
                value = max(values)
            elif agg == "avg":
                value = sum(values) / len(values)
            else:
                value = sum(values)
            out.append((bucket * self.resolution_s, value))
        return out

    @staticmethod
    def _ring_increase(ring, start_bucket: int,
                       end_bucket: int) -> Optional[float]:
        """Reset-aware counter increase over one ring's window: sums
        positive deltas; a drop to a smaller value contributes the
        post-reset value, never a negative delta. None = no points."""
        pts = ring.points(start_bucket, end_bucket)
        if not pts:
            return None
        prev = pts[0][1]
        inc = 0.0
        for _, value in pts[1:]:
            inc += value - prev if value >= prev else value
            prev = value
        return inc

    def increase(self, name: str, window: float, at: float,
                 labels: Optional[dict] = None) -> float:
        """Windowed counter increase summed across matching series."""
        total = 0.0
        start_bucket = self._bucket(at - window)
        end_bucket = self._bucket(at)
        for _, ring in self._select(name, labels):
            inc = self._ring_increase(ring, start_bucket, end_bucket)
            if inc is not None:
                total += inc
        return total

    def rate(self, name: str, window: float, at: float,
             labels: Optional[dict] = None) -> float:
        return self.increase(name, window, at, labels) / window \
            if window > 0 else 0.0

    # -- histogram queries ---------------------------------------------------
    def _bucket_increases(self, family: str, window: float, at: float,
                          labels: Optional[dict] = None) -> list:
        """Windowed increase per ``le`` bound, summed across every other
        label dimension (fleet-wide): ``[(bound, increase)]`` sorted."""
        per_le: dict[float, float] = {}
        start_bucket = self._bucket(at - window)
        end_bucket = self._bucket(at)
        for series_labels, ring in self._select(family + "_bucket", labels):
            le = dict(series_labels).get("le")
            if le is None:
                continue
            bound = math.inf if le == "+Inf" else float(le)
            inc = self._ring_increase(ring, start_bucket, end_bucket)
            if inc is None:
                continue
            per_le[bound] = per_le.get(bound, 0.0) + inc
        return sorted(per_le.items())

    def quantile(self, family: str, q: float, window: float, at: float,
                 labels: Optional[dict] = None) -> Optional[float]:
        """Windowed quantile from cumulative bucket counters (Prometheus
        ``histogram_quantile`` semantics: linear interpolation inside the
        winning bucket; the +Inf bucket answers with the highest finite
        bound). None when the window saw no observations."""
        buckets = self._bucket_increases(family, window, at, labels)
        if not buckets:
            return None
        total = buckets[-1][1]
        if total <= 0:
            return None
        target = q * total
        prev_bound, prev_cum = 0.0, 0.0
        for bound, cum in buckets:
            if cum >= target:
                if math.isinf(bound):
                    return prev_bound
                if cum == prev_cum:
                    return bound
                frac = (target - prev_cum) / (cum - prev_cum)
                return prev_bound + frac * (bound - prev_bound)
            prev_bound, prev_cum = bound, cum
        return prev_bound

    def fraction_over(self, family: str, threshold: float, window: float,
                      at: float,
                      labels: Optional[dict] = None) -> Optional[float]:
        """Fraction of windowed observations above ``threshold`` — the
        latency-SLO "bad events" ratio, interpolated within the bucket
        the threshold falls into. None when the window saw nothing."""
        buckets = self._bucket_increases(family, window, at, labels)
        if not buckets:
            return None
        total = buckets[-1][1]
        if total <= 0:
            return None
        prev_bound, prev_cum = 0.0, 0.0
        under = total
        for bound, cum in buckets:
            if threshold <= bound:
                if math.isinf(bound):
                    # the threshold is past the highest finite bound:
                    # where +Inf-bucket observations fall relative to it
                    # is unknown — count them as OVER (a total-outage
                    # histogram must not read as 0.0 bad fraction just
                    # because its buckets top out below the target)
                    under = prev_cum
                elif bound == prev_bound:
                    under = cum
                else:
                    frac = (threshold - prev_bound) / (bound - prev_bound)
                    under = prev_cum + frac * (cum - prev_cum)
                break
            prev_bound, prev_cum = bound, cum
        return max(0.0, min(1.0, (total - under) / total))


# -- grafana simpleJSON contract ---------------------------------------------
def parse_target(spec: str):
    """Parse a simpleJSON target: ``name``, ``name{k="v",...}``,
    ``rate(name{...})[window]``, ``p95(family)[window]``. Returns
    ``(fn, name, labels, window)``; fn None = raw series."""
    match = _TARGET_RE.match(spec.strip())
    if not match:
        raise ValueError(f"bad target: {spec!r}")
    labels = dict(_TARGET_LABEL_RE.findall(match.group("labels") or ""))
    window = float(match.group("window")) if match.group("window") else 60.0
    return match.group("fn"), match.group("name"), labels, window


# function targets evaluate per bucket — cap the response (and the CPU
# spent in the executor) for arbitrarily wide dashboard ranges by
# striding, grafana maxDataPoints-style
GRAFANA_MAX_POINTS = 2000


def grafana_query(store: TimeSeriesStore, spec: str, start: float,
                  end: float) -> dict:
    """One simpleJSON ``timeserie`` response entry for ``spec``:
    ``{"target", "datapoints": [[value, ts_millis], ...]}``. Function
    targets (rate/pXX) evaluate per bucket over their trailing window,
    strided down to at most :data:`GRAFANA_MAX_POINTS` points."""
    if end < start:
        raise ValueError(f"range end {end} before start {start}")
    fn, name, labels, window = parse_target(spec)
    datapoints = []
    if fn is None:
        for ts, value in store.points(name, start, end, labels=labels):
            datapoints.append([value, ts * 1000.0])
    elif fn != "rate" or store._select(name, labels):
        # (a rate over a series the store has never seen returns 0.0,
        # not None — skip it entirely so "no data" stays distinguishable
        # from "zero traffic" on the panel)
        step = store.resolution_s
        steps = int((end - start) // step) + 1
        stride = step * max(1, math.ceil(steps / GRAFANA_MAX_POINTS))
        ts = math.ceil(start / step) * step
        while ts <= end:
            if fn == "rate":
                value = store.rate(name, window, ts, labels=labels)
            else:
                value = store.quantile(name, _QUANTILE_FNS[fn], window,
                                       ts, labels=labels)
            if value is not None:
                datapoints.append([value, ts * 1000.0])
            ts += stride
    return {"target": spec, "datapoints": datapoints}


# -- process-global store -----------------------------------------------------
# the SLO and autoscaler loops share one store per process (tests swap it
# with set_store)
_STORE: Optional[TimeSeriesStore] = None
_STORE_LOCK = threading.Lock()


def get_store() -> TimeSeriesStore:
    global _STORE
    with _STORE_LOCK:
        if _STORE is None:
            _STORE = TimeSeriesStore.from_mlconf()
        return _STORE


def set_store(store: Optional[TimeSeriesStore]):
    global _STORE
    with _STORE_LOCK:
        _STORE = store
