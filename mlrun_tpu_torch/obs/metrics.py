"""Thread-safe metrics registry with Prometheus text exposition — the
port's own copy of ``mlrun_tpu/obs/metrics.py`` (same families, label
rules, bounds and text format, so one scrape config reads both packages).

``Counter`` / ``Gauge`` / ``Histogram`` families with label sets, bounded
cardinality (a typed :class:`CardinalityError` on overflow, or a silent
drop for hot paths that must never raise), histogram exemplars, and
``render()`` producing the Prometheus text format (OpenMetrics with
exemplars on request).

- **Bottom layer.** Stdlib only, no imports of the port's other modules.
- **Cheap when hot.** An ``inc``/``observe`` is one lock + dict update;
  collectors and formatting run only at scrape time.
- **Bounded.** Every metric caps its label-set count.
"""

from __future__ import annotations

import math
import re
import threading
import time
from typing import Callable, Iterable, Optional

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# default bucket bounds for latency histograms (seconds) — spans TTFT on
# a warm engine (~ms) through deadline-class request times
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

DEFAULT_MAX_LABEL_SETS = 256


class MetricError(RuntimeError):
    """Base for registry misuse (name clash, bad labels)."""


class CardinalityError(MetricError):
    """A metric exceeded its label-set bound — the series was NOT
    created. Raised instead of growing unbounded (a runaway label value
    would otherwise eat the process from inside a counter)."""


def _escape_label(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(value: str) -> str:
    return str(value).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt(value: float) -> str:
    if value != value:  # NaN
        return "NaN"
    if value in (math.inf, -math.inf):
        return "+Inf" if value > 0 else "-Inf"
    if float(value).is_integer() and abs(value) < 1e15:
        return str(int(value))
    return repr(float(value))


class _Metric:
    """Shared series bookkeeping: label validation, cardinality bound,
    per-metric lock."""

    type_name = ""

    def __init__(self, name: str, help: str = "",
                 labels: Iterable[str] = (),
                 max_label_sets: int | None = None,
                 overflow: str = "raise"):
        if not _NAME_RE.match(name):
            raise MetricError(f"invalid metric name '{name}'")
        for label in labels:
            if not _LABEL_RE.match(label):
                raise MetricError(
                    f"metric '{name}': invalid label name '{label}'")
        if overflow not in ("raise", "drop"):
            raise MetricError(
                f"metric '{name}': overflow must be 'raise' or 'drop'")
        self.name = name
        self.help = help
        self.labelnames = tuple(labels)
        self.max_label_sets = (DEFAULT_MAX_LABEL_SETS
                               if max_label_sets is None
                               else int(max_label_sets))
        self.overflow = overflow
        self.dropped = 0  # series lost to the cardinality bound (drop mode)
        self._lock = threading.Lock()
        self._series: dict[tuple, object] = {}

    def _key(self, labels: dict) -> tuple:
        if set(labels) != set(self.labelnames):
            raise MetricError(
                f"metric '{self.name}' takes labels "
                f"{sorted(self.labelnames)}, got {sorted(labels)}")
        return tuple(str(labels[name]) for name in self.labelnames)

    def _get_or_create(self, key: tuple, factory: Callable):
        """Caller holds ``self._lock``. Returns None when the series was
        dropped by the cardinality bound in drop mode."""
        series = self._series.get(key)
        if series is None:
            if len(self._series) >= self.max_label_sets:
                if self.overflow == "drop":
                    self.dropped += 1
                    return None
                raise CardinalityError(
                    f"metric '{self.name}' exceeded its label-set bound "
                    f"({self.max_label_sets}); refusing to create series "
                    f"for labels {dict(zip(self.labelnames, key))}")
            series = factory()
            self._series[key] = series
        return series

    def remove(self, **labels):
        """Drop one series (engines remove their gauges on stop so a
        process churning short-lived engines doesn't pin stale series)."""
        key = self._key(labels)
        with self._lock:
            self._series.pop(key, None)

    def clear(self):
        with self._lock:
            self._series.clear()
            self.dropped = 0

    def _labels_suffix(self, key: tuple, extra: str = "") -> str:
        parts = [f'{name}="{_escape_label(value)}"'
                 for name, value in zip(self.labelnames, key)]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def render(self, openmetrics: bool = False) -> list[str]:
        raise NotImplementedError


class Counter(_Metric):
    """Monotone counter. ``inc`` adds; ``set_total`` syncs to an absolute
    monotone total (for collectors mirroring an existing cumulative stat,
    e.g. an engine's ``prefix_hits``) and never moves backwards."""

    type_name = "counter"

    def inc(self, value: float = 1.0, **labels):
        if value < 0:
            raise MetricError(
                f"counter '{self.name}' cannot decrease (inc {value})")
        key = self._key(labels)
        with self._lock:
            if self._get_or_create(key, float) is not None:
                self._series[key] += value

    def set_total(self, value: float, **labels):
        key = self._key(labels)
        with self._lock:
            current = self._get_or_create(key, float)
            if current is not None and value > current:
                self._series[key] = float(value)

    def value(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            return float(self._series.get(key, 0.0))

    def om_family(self) -> str:
        """OpenMetrics family name: the spec says a counter family
        ``foo`` exposes samples ``foo_total`` — so the TYPE/HELP lines
        must strip our ``_total`` suffix, or a strict scraper (stock
        Prometheus negotiates OpenMetrics by default) rejects the whole
        scrape expecting ``foo_total_total`` samples."""
        return self.name[:-len("_total")] \
            if self.name.endswith("_total") else self.name

    def render(self, openmetrics: bool = False) -> list[str]:
        with self._lock:
            items = sorted(self._series.items())
        # OpenMetrics: sample name = family + "_total". Families already
        # named *_total keep their sample names byte-identical (only the
        # TYPE/HELP family name changes); the rare counter without the
        # suffix gains it in the OM variant only.
        name = self.om_family() + "_total" if openmetrics else self.name
        return [f"{name}{self._labels_suffix(key)} {_fmt(value)}"
                for key, value in items]


class Gauge(_Metric):
    """Point-in-time value (queue depth, free-page fraction, breaker
    state)."""

    type_name = "gauge"

    def set(self, value: float, **labels):
        key = self._key(labels)
        with self._lock:
            if self._get_or_create(key, float) is not None:
                self._series[key] = float(value)

    def inc(self, value: float = 1.0, **labels):
        key = self._key(labels)
        with self._lock:
            if self._get_or_create(key, float) is not None:
                self._series[key] += value

    def dec(self, value: float = 1.0, **labels):
        self.inc(-value, **labels)

    def value(self, **labels) -> float:
        key = self._key(labels)
        with self._lock:
            return float(self._series.get(key, 0.0))

    def render(self, openmetrics: bool = False) -> list[str]:
        with self._lock:
            items = sorted(self._series.items())
        return [f"{self.name}{self._labels_suffix(key)} {_fmt(value)}"
                for key, value in items]


class _HistogramSeries:
    __slots__ = ("counts", "sum", "count", "exemplars")

    def __init__(self, n_buckets: int):
        self.counts = [0] * n_buckets  # per-bucket (non-cumulative)
        self.sum = 0.0
        self.count = 0
        # one exemplar slot per bucket (+Inf included), allocated on the
        # first exemplar so exemplar-free histograms pay nothing; each
        # slot is (value, labels-dict, unix-ts), last write wins
        self.exemplars: Optional[list] = None


class Histogram(_Metric):
    """Fixed-bound histogram; exposition emits cumulative ``_bucket``
    series (with the implicit ``+Inf``), ``_sum`` and ``_count``."""

    type_name = "histogram"

    def __init__(self, name: str, help: str = "",
                 labels: Iterable[str] = (),
                 buckets: Iterable[float] | None = None,
                 max_label_sets: int | None = None,
                 overflow: str = "raise"):
        super().__init__(name, help, labels, max_label_sets, overflow)
        bounds = tuple(sorted(float(b) for b in (buckets or DEFAULT_BUCKETS)))
        if not bounds:
            raise MetricError(f"histogram '{name}' needs >= 1 bucket bound")
        self.buckets = bounds

    def observe(self, value: float, exemplar=None, **labels):
        """``exemplar`` optionally attaches a trace reference to the
        observation's bucket: a trace-id string or a small labels
        dict. One slot per bucket, last write wins —
        lock-cheap (the same per-metric lock the counts take, one tuple
        assignment), rendered only on the OpenMetrics content type."""
        key = self._key(labels)
        with self._lock:
            series = self._get_or_create(
                key, lambda: _HistogramSeries(len(self.buckets)))
            if series is None:
                return
            bucket_index = len(self.buckets)  # +Inf slot
            for index, bound in enumerate(self.buckets):
                if value <= bound:
                    series.counts[index] += 1
                    bucket_index = index
                    break
            series.sum += value
            series.count += 1
            if exemplar is not None:
                if series.exemplars is None:
                    series.exemplars = [None] * (len(self.buckets) + 1)
                if not isinstance(exemplar, dict):
                    exemplar = {"trace_id": str(exemplar)}
                series.exemplars[bucket_index] = (
                    float(value), exemplar, time.time())

    def value(self, **labels) -> dict:
        key = self._key(labels)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                return {"count": 0, "sum": 0.0}
            return {"count": series.count, "sum": series.sum}

    def exemplars(self, match: Optional[dict] = None) -> list[dict]:
        """Exemplars across series whose labels contain ``match`` (the SLO
        evaluator's breach-forensics read): one entry per occupied bucket
        slot — ``{series, le, value, labels, ts}`` — so "worst offenders"
        is a sort by value over this list."""
        match_items = set((k, str(v)) for k, v in (match or {}).items())
        out = []
        with self._lock:
            items = [(key, series.exemplars)
                     for key, series in self._series.items()
                     if series.exemplars is not None]
        bounds = list(self.buckets) + [math.inf]
        for key, slots in items:
            series_labels = dict(zip(self.labelnames, key))
            if not match_items <= set(
                    (k, str(v)) for k, v in series_labels.items()):
                continue
            for index, slot in enumerate(slots):
                if slot is None:
                    continue
                value, labels, ts = slot
                out.append({"series": series_labels, "le": bounds[index],
                            "value": value, "labels": dict(labels),
                            "ts": ts})
        return out

    @staticmethod
    def _exemplar_suffix(slot) -> str:
        """OpenMetrics exemplar clause for one bucket line:
        `` # {label="value",...} <value> <timestamp>``."""
        if slot is None:
            return ""
        value, labels, ts = slot
        body = ",".join(f'{k}="{_escape_label(v)}"'
                        for k, v in sorted(labels.items()))
        return f" # {{{body}}} {_fmt(value)} {ts:.3f}"

    def render(self, openmetrics: bool = False) -> list[str]:
        with self._lock:
            items = sorted(
                (key, list(series.counts), series.sum, series.count,
                 list(series.exemplars) if series.exemplars else None)
                for key, series in self._series.items())
        lines = []
        for key, counts, total, count, exemplars in items:
            cumulative = 0
            for index, (bound, bucket_count) in enumerate(
                    zip(self.buckets, counts)):
                cumulative += bucket_count
                le = 'le="' + _fmt(bound) + '"'
                extra = self._exemplar_suffix(exemplars[index]) \
                    if openmetrics and exemplars else ""
                lines.append(f"{self.name}_bucket"
                             f"{self._labels_suffix(key, le)} "
                             f"{cumulative}{extra}")
            le_inf = 'le="+Inf"'
            extra = self._exemplar_suffix(exemplars[-1]) \
                if openmetrics and exemplars else ""
            lines.append(f"{self.name}_bucket"
                         f"{self._labels_suffix(key, le_inf)} "
                         f"{count}{extra}")
            lines.append(
                f"{self.name}_sum{self._labels_suffix(key)} {_fmt(total)}")
            lines.append(
                f"{self.name}_count{self._labels_suffix(key)} {count}")
        return lines


class MetricsRegistry:
    """Process-wide metric families + scrape-time collectors.

    ``counter``/``gauge``/``histogram`` are get-or-create: re-declaring
    the same name with the same type returns the existing family (so
    module reloads and multiple importers agree); a type clash is a
    :class:`MetricError`.

    Collectors are callables invoked at scrape time, for state that is
    cheaper to read on demand than to push per-event (engine queue
    depth, breaker states). A collector returning ``False`` is removed —
    the weakref-friendly retirement contract for collectors bound to
    short-lived objects.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}
        self._collectors: list[Callable] = []

    def _declare(self, cls, name: str, help: str, **kwargs) -> _Metric:
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise MetricError(
                        f"metric '{name}' already registered as "
                        f"{existing.type_name}, not {cls.type_name}")
                return existing
            metric = cls(name, help, **kwargs)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "", **kwargs) -> Counter:
        return self._declare(Counter, name, help, **kwargs)

    def gauge(self, name: str, help: str = "", **kwargs) -> Gauge:
        return self._declare(Gauge, name, help, **kwargs)

    def histogram(self, name: str, help: str = "", **kwargs) -> Histogram:
        return self._declare(Histogram, name, help, **kwargs)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def add_collector(self, collector: Callable) -> Callable:
        with self._lock:
            self._collectors.append(collector)
        return collector

    def remove_collector(self, collector: Callable):
        with self._lock:
            if collector in self._collectors:
                self._collectors.remove(collector)

    def collect(self):
        """Run scrape-time collectors; retire the ones reporting False
        (their backing object is gone)."""
        with self._lock:
            collectors = list(self._collectors)
        retired = []
        for collector in collectors:
            try:
                if collector() is False:
                    retired.append(collector)
            except Exception:  # noqa: BLE001 - one bad collector must not
                # take the whole scrape down
                retired.append(collector)
        for collector in retired:
            self.remove_collector(collector)

    def render(self, openmetrics: bool = False) -> str:
        """Text exposition: Prometheus 0.0.4 by default; with
        ``openmetrics`` the histogram bucket lines additionally carry
        their exemplars in OpenMetrics syntax and the body ends with
        ``# EOF``."""
        self.collect()
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        lines = []
        for metric in metrics:
            family = metric.om_family() \
                if openmetrics and isinstance(metric, Counter) \
                else metric.name
            lines.append(f"# HELP {family} "
                         f"{_escape_help(metric.help or metric.name)}")
            lines.append(f"# TYPE {family} {metric.type_name}")
            lines.extend(metric.render(openmetrics=openmetrics))
        if openmetrics:
            lines.append("# EOF")
        return "\n".join(lines) + "\n"

    def reset(self):
        """Zero every series (tests); families and collectors survive."""
        with self._lock:
            metrics = list(self._metrics.values())
        for metric in metrics:
            metric.clear()


# the process-wide registry a /metrics endpoint renders
REGISTRY = MetricsRegistry()

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
# negotiated via the Accept header on the /metrics endpoint — the only
# format whose bucket lines carry exemplars
OPENMETRICS_CONTENT_TYPE = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8")


def wants_openmetrics(accept: str | None) -> bool:
    """Content negotiation for the /metrics endpoint: OpenMetrics only
    when the client asks for it by name (Prometheus text 0.0.4 stays
    the default for every other Accept value)."""
    return bool(accept) and "application/openmetrics-text" in accept
