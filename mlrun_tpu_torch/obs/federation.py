"""Metrics federation: Prometheus text parsing and fleet-wide aggregation
— the port's own copy of ``mlrun_tpu/obs/federation.py`` (same parser,
merge semantics, staleness and cardinality rules, so the same scrapes
merge to the same view in both packages).

Every process has a registry and a ``/metrics`` endpoint, and N engine
replicas stand behind one fleet. A replica's queue depth, page headroom
and TTFT histogram mean nothing for scaling until they are merged into
one fleet-wide view. This module is that ingest path:

- :func:`parse_exposition` / :func:`parse_prometheus` — the strict
  text-format (0.0.4) parser, OpenMetrics exemplars included.
- :class:`MetricsAggregator` — ingests per-replica ``/metrics`` scrapes
  (``ingest_text``) and in-process ``EngineFleet.stats`` feeds
  (``ingest_stats``) into one merged view with per-family merge
  semantics: counters and histogram samples SUM across sources, gauges
  take the newest source's value (``"last"``) or ``"max"`` / ``"sum"``
  per family. The ``replica`` label is preserved verbatim; merging only
  collapses identical (name, label-set) series reported by different
  sources.
- Staleness bounds: a source not refreshed within ``stale_after``
  seconds drops out of the merged view.
- Cardinality budget: total series across live sources is bounded;
  overflow drops deterministically and counts.

Stdlib only at module level — ``from_mlconf`` lazy-imports the config.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Optional

_SAMPLE_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>.*)\})?'
    r' (?P<value>[+-]?(?:[0-9]+(?:\.[0-9]+)?(?:e[+-]?[0-9]+)?|Inf|NaN))$',
    re.IGNORECASE)
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')

_HISTOGRAM_SUFFIXES = ("_bucket", "_sum", "_count")


class PromParseError(ValueError):
    """A scrape violated the exposition format contract."""


# quote-aware labels group (a literal "}" inside an escaped label value
# must not end the clause early) + the same Inf/NaN value forms the
# sample regex accepts — the renderer's own output must always parse,
# or one odd exemplar poisons a replica's entire federated scrape
_EXEMPLAR_LABEL = r'[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"'
_EXEMPLAR_RE = re.compile(
    r'^\{(?P<labels>(?:' + _EXEMPLAR_LABEL +
    r'(?:,' + _EXEMPLAR_LABEL + r')*)?)\} '
    r'(?P<value>[+-]?(?:[0-9]+(?:\.[0-9]+)?(?:e[+-]?[0-9]+)?|Inf|NaN))'
    r'(?: (?P<ts>[0-9]+(?:\.[0-9]+)?))?$', re.IGNORECASE)


def parse_exposition(text: str):
    """Parse Prometheus text exposition (format 0.0.4) — and the
    OpenMetrics variant our renderer produces (``# EOF`` trailer plus
    per-bucket exemplar clauses after `` # ``).

    Returns ``(samples, types, exemplars)`` where ``samples`` maps
    ``(name, frozenset((label, value), ...))`` to a float, ``types``
    maps each family name to ``counter``/``gauge``/``histogram``, and
    ``exemplars`` maps sample keys to
    ``{"labels", "value", "ts"}`` dicts.

    Strict by design — this parses OUR renderer's output (and sibling
    replicas running the same code), so any malformed line, unknown
    comment, or typed family without a HELP line raises
    :class:`PromParseError` instead of being skipped.
    """
    samples: dict[tuple, float] = {}
    types: dict[str, str] = {}
    exemplars: dict[tuple, dict] = {}
    helped: set[str] = set()
    for line in text.strip().splitlines():
        if not line:
            continue
        if line == "# EOF":
            continue  # OpenMetrics trailer
        if line.startswith("# HELP "):
            helped.add(line.split()[2])
            continue
        if line.startswith("# TYPE "):
            _, _, family, type_name = line.split(maxsplit=3)
            if type_name not in ("counter", "gauge", "histogram"):
                raise PromParseError(f"unknown metric type: {line!r}")
            types[family] = type_name
            continue
        if line.startswith("#"):
            raise PromParseError(f"unknown comment line: {line!r}")
        exemplar = None
        # exemplar detection guards: split at the LAST " # ", require a
        # "{"-opening clause AND a well-formed sample on the left — a
        # literal " # {" inside a quoted label value (label values are
        # client-supplied, e.g. adapter ids) must fall through to the
        # whole-line sample parse, not poison the scrape as a
        # "malformed exemplar"
        sample_part, sep, exemplar_part = line.rpartition(" # ")
        if sep and exemplar_part.lstrip().startswith("{") \
                and _SAMPLE_RE.match(sample_part):
            ex_match = _EXEMPLAR_RE.match(exemplar_part.strip())
            if not ex_match:
                raise PromParseError(f"malformed exemplar: {line!r}")
            exemplar = {
                "labels": dict(_LABEL_RE.findall(
                    ex_match.group("labels") or "")),
                "value": float(ex_match.group("value")),
                "ts": (float(ex_match.group("ts"))
                       if ex_match.group("ts") else None),
            }
            line = sample_part
        match = _SAMPLE_RE.match(line)
        if not match:
            raise PromParseError(f"malformed sample line: {line!r}")
        labels = frozenset(_LABEL_RE.findall(match.group("labels") or ""))
        value = match.group("value")
        key = (match.group("name"), labels)
        samples[key] = (
            math.inf if value == "+Inf"
            else -math.inf if value == "-Inf" else float(value))
        if exemplar is not None:
            exemplars[key] = exemplar
    if not set(types) <= helped:
        raise PromParseError(
            f"typed families missing HELP: {sorted(set(types) - helped)}")
    return samples, types, exemplars


def parse_prometheus(text: str):
    """Back-compat two-tuple view of :func:`parse_exposition` (the
    format tests and every pre-exemplar caller use this shape)."""
    samples, types, _ = parse_exposition(text)
    return samples, types


def check_histogram_consistency(samples: dict, family: str):
    """Assert ``family``'s bucket series are cumulative and
    non-decreasing, ``+Inf`` equals ``_count``, and ``_sum`` is present —
    per label group. Raises :class:`PromParseError` on violation (the
    merged view must stay a valid histogram, not just each source)."""
    groups: dict[frozenset, dict] = {}
    for (name, labels), value in samples.items():
        if not name.startswith(family):
            continue
        suffix = name[len(family):]
        if suffix not in _HISTOGRAM_SUFFIXES:
            continue
        base = frozenset(kv for kv in labels if kv[0] != "le")
        groups.setdefault(base, {})[
            (suffix, dict(labels).get("le"))] = value
    if not groups:
        raise PromParseError(f"no samples for histogram {family}")
    for base, series in groups.items():
        buckets = sorted(
            ((math.inf if le == "+Inf" else float(le)), value)
            for (suffix, le), value in series.items()
            if suffix == "_bucket")
        counts = [value for _, value in buckets]
        if counts != sorted(counts):
            raise PromParseError(
                f"non-cumulative buckets for {family}: {sorted(base)}")
        if not buckets or buckets[-1][0] != math.inf:
            raise PromParseError(f"{family} missing +Inf bucket")
        if buckets[-1][1] != series.get(("_count", None)):
            raise PromParseError(
                f"{family} +Inf bucket != _count: {sorted(base)}")
        if ("_sum", None) not in series:
            raise PromParseError(f"{family} missing _sum: {sorted(base)}")


def sample_kind(name: str, types: dict) -> tuple[str, str]:
    """Resolve a sample line's merge family + kind: histogram component
    samples (``_bucket``/``_sum``/``_count``) map back to their base
    family, an OpenMetrics counter sample (``foo_total`` under
    ``# TYPE foo counter``) back to its stripped family; unknown names
    default to gauge semantics."""
    if name in types:
        return name, types[name]
    for suffix in _HISTOGRAM_SUFFIXES:
        if name.endswith(suffix):
            base = name[: -len(suffix)]
            if types.get(base) == "histogram":
                return base, "histogram"
    if name.endswith("_total") \
            and types.get(name[: -len("_total")]) == "counter":
        return name[: -len("_total")], "counter"
    return name, "gauge"


class _Source:
    __slots__ = ("samples", "types", "at", "exemplars")

    def __init__(self, samples: dict, types: dict, at: float,
                 exemplars: Optional[dict] = None):
        self.samples = samples
        self.types = types
        self.at = float(at)
        self.exemplars = exemplars or {}


class MetricsAggregator:
    """Merged fleet-wide view over per-source sample sets.

    ``gauge_merge`` maps a gauge family to ``"last"`` (newest source
    wins — the default), ``"max"``, or ``"sum"`` for the rare gauge
    where cross-source addition is meaningful (e.g. in-flight counts).
    Counters and histograms always sum.

    Feed each underlying producer through exactly ONE channel — either
    its ``/metrics`` scrape or its in-process stats feed — or the merged
    counters double-count.
    """

    def __init__(self, stale_after: float = 60.0,
                 max_series: int = 4096,
                 gauge_merge: Optional[dict] = None):
        if stale_after <= 0:
            raise ValueError("stale_after must be > 0")
        if max_series <= 0:
            raise ValueError("max_series must be > 0")
        self.stale_after = float(stale_after)
        self.max_series = int(max_series)
        self.gauge_merge = dict(gauge_merge or {})
        self.dropped_series = 0  # series lost to the cardinality budget
        self._lock = threading.Lock()
        self._sources: dict[str, _Source] = {}

    @classmethod
    def from_mlconf(cls, **overrides) -> "MetricsAggregator":
        """An aggregator on ``config.OBSERVABILITY_DEFAULTS
        ["federation"]``, with keyword overrides."""
        from ..config import OBSERVABILITY_DEFAULTS

        fed = OBSERVABILITY_DEFAULTS["federation"]
        kwargs = {"stale_after": float(fed["stale_after_s"]),
                  "max_series": int(fed["max_series"])}
        kwargs.update(overrides)
        return cls(**kwargs)

    # -- ingest --------------------------------------------------------------
    def ingest_text(self, source: str, text: str, at: float):
        """Ingest one ``/metrics`` scrape from ``source`` (replaces the
        source's previous sample set). ``at`` is the scrape timestamp —
        passed explicitly so staleness is testable without wall-clock
        sleeps. Raises :class:`PromParseError` on a malformed scrape.
        An OpenMetrics scrape's exemplars ride along with their bucket
        samples (readable via :meth:`exemplars`) without counting
        against the cardinality budget — they are annotations on
        existing series, not series."""
        samples, types, exemplars = parse_exposition(text)
        self._store(source, samples, types, at, exemplars)

    def ingest_stats(self, source: str, stats: dict, at: float,
                     engine: str = "fleet"):
        """Ingest an in-process ``EngineFleet.stats`` feed, mapped onto
        the same canonical families a scrape produces so the merged view
        is uniform:

        - per-replica ``queue_depth`` / ``free_page_frac`` →
          ``mlt_llm_queue_depth`` / ``mlt_llm_free_page_frac`` gauges,
        - per-replica cumulative ``requests``/``completed`` →
          ``mlt_llm_events_total`` counters,
        - fleet dispatch counters → ``mlt_fleet_dispatches_total``
          (outcome ok/redispatch/failed/no_replica),
        - fleet TTFT percentiles → ``mlt_fleet_ttft_seconds`` gauges
          with a ``quantile`` label.
        """
        samples: dict[tuple, float] = {}
        types = {"mlt_llm_queue_depth": "gauge",
                 "mlt_llm_free_page_frac": "gauge",
                 "mlt_llm_events_total": "counter",
                 "mlt_fleet_dispatches_total": "counter",
                 "mlt_fleet_ttft_seconds": "gauge"}

        def put(name, value, **labels):
            samples[(name, frozenset(labels.items()))] = float(value)

        for rid, per in (stats.get("per_replica") or {}).items():
            if "queue_depth" in per:
                put("mlt_llm_queue_depth", per["queue_depth"],
                    engine=engine, replica=rid)
            if per.get("free_page_frac") is not None:
                put("mlt_llm_free_page_frac", per["free_page_frac"],
                    engine=engine, replica=rid)
            for event in ("requests", "completed"):
                if event in per:
                    put("mlt_llm_events_total", per[event],
                        engine=engine, replica=rid, event=event)
        for key, outcome in (("dispatches", "ok"),
                             ("redispatches", "redispatch"),
                             ("failed", "failed"),
                             ("no_replica", "no_replica")):
            if key in stats:
                put("mlt_fleet_dispatches_total", stats[key],
                    replica="", outcome=outcome)
        for key, quantile in (("ttft_p50_s", "0.5"), ("ttft_p95_s", "0.95")):
            if key in stats:
                put("mlt_fleet_ttft_seconds", stats[key],
                    quantile=quantile)
        self._store(source, samples, types, at)

    def _store(self, source: str, samples: dict, types: dict, at: float,
               exemplars: Optional[dict] = None):
        with self._lock:
            # evict sources already past the staleness bound relative to
            # this scrape — a dead replica's frozen sample set must not
            # keep consuming the cardinality budget (if it comes back,
            # its next scrape re-ingests in full)
            for name in [n for n, s in self._sources.items()
                         if n != source and at - s.at > self.stale_after]:
                del self._sources[name]
            other = sum(len(s.samples) for name, s in self._sources.items()
                        if name != source)
            allowed = self.max_series - other
            if len(samples) > allowed:
                # deterministic truncation: keep the lexicographically
                # first `allowed` series so repeated over-budget scrapes
                # drop the SAME tail, not a churning random subset
                keep = sorted(samples, key=lambda k: (k[0], sorted(k[1])))
                dropped = len(samples) - max(allowed, 0)
                self.dropped_series += dropped
                samples = {key: samples[key]
                           for key in keep[:max(allowed, 0)]}
            if exemplars:
                # exemplars never extend the series set — one whose
                # bucket sample fell to the truncation goes with it
                exemplars = {key: ex for key, ex in exemplars.items()
                             if key in samples}
            self._sources[source] = _Source(samples, types, at, exemplars)

    def forget(self, source: str):
        """Drop a source outright (a removed replica's scrape target)."""
        with self._lock:
            self._sources.pop(source, None)

    # -- merged view ---------------------------------------------------------
    def sources(self, now: float) -> dict:
        """Per-source freshness: ``{name: {at, fresh, series}}``."""
        with self._lock:
            return {name: {"at": src.at,
                           "fresh": now - src.at <= self.stale_after,
                           "series": len(src.samples)}
                    for name, src in self._sources.items()}

    def _fresh(self, now: float) -> list[tuple[str, _Source]]:
        return [(name, src) for name, src in sorted(self._sources.items())
                if now - src.at <= self.stale_after]

    def merged(self, now: float):
        """The fleet-wide view at ``now``: ``(samples, types)`` in the
        same shape :func:`parse_prometheus` returns, merged across fresh
        sources with per-family semantics."""
        with self._lock:
            fresh = self._fresh(now)
            merged: dict[tuple, float] = {}
            newest: dict[tuple, float] = {}
            types: dict[str, str] = {}
            for _, src in fresh:
                types.update(src.types)
            for _, src in fresh:
                for key, value in src.samples.items():
                    family, kind = sample_kind(key[0], types)
                    if key not in merged:
                        merged[key] = value
                        newest[key] = src.at
                        continue
                    if kind in ("counter", "histogram"):
                        merged[key] += value
                    else:
                        mode = self.gauge_merge.get(family, "last")
                        if mode == "sum":
                            merged[key] += value
                        elif mode == "max":
                            merged[key] = max(merged[key], value)
                        elif src.at >= newest[key]:  # last
                            merged[key] = value
                            newest[key] = src.at
        return merged, types

    def snapshot_to(self, store, now: float):
        """Record the fleet view into a ``TimeSeriesStore``: gauges from
        the merged view, but counter/histogram samples PER SOURCE (extra
        ``source`` label). A summed cumulative series would DROP when a
        source goes stale or is forgotten, and the store's reset
        convention would read that drop as a counter restart — inflating
        windowed ``increase()``/``quantile()`` by the survivors' full
        totals. Per-source rings just go quiet instead. Windowed reads
        sum across label sets, so fleet-wide queries are unchanged."""
        samples, types = self.merged(now)
        for (name, labels), value in samples.items():
            _, kind = sample_kind(name, types)
            if kind == "gauge" and math.isfinite(value):
                store.record(name, value, now, labels=dict(labels),
                             kind="gauge")
        with self._lock:
            fresh = self._fresh(now)
        for src_name, src in fresh:
            for (name, labels), value in src.samples.items():
                _, kind = sample_kind(name, src.types)
                if kind in ("counter", "histogram") \
                        and math.isfinite(value):
                    store.record(
                        name, value, now,
                        labels={**dict(labels), "source": src_name},
                        kind="counter")

    # -- queries -------------------------------------------------------------
    def value(self, name: str, now: float, **labels) -> Optional[float]:
        samples, _ = self.merged(now)
        return samples.get((name, frozenset(
            {k: str(v) for k, v in labels.items()}.items())))

    def family(self, name: str, now: float) -> dict:
        """Exact-name samples: ``{labels-frozenset: value}``."""
        samples, _ = self.merged(now)
        return {labels: value for (n, labels), value in samples.items()
                if n == name}

    def label_values(self, name: str, label: str, now: float) -> set:
        """Distinct values of ``label`` across ``name``'s merged series
        (e.g. the live ``replica`` set under ``mlt_llm_queue_depth``)."""
        return {dict(labels).get(label)
                for labels in self.family(name, now)
                if dict(labels).get(label) is not None}

    def series_count(self, now: float) -> int:
        samples, _ = self.merged(now)
        return len(samples)

    def sum_family(self, name: str, now: float,
                   match: Optional[dict] = None) -> float:
        """Sum a family's merged samples, optionally filtered by a label
        subset — the fleet-total shortcut the autoscaler's signals use."""
        match_items = set((match or {}).items())
        return sum(value for labels, value in self.family(name, now).items()
                   if match_items <= set(labels))

    def min_family(self, name: str, now: float) -> Optional[float]:
        values = list(self.family(name, now).values())
        return min(values) if values else None

    # -- exemplars -----------------------------------------------------------
    def exemplars(self, family: str, now: float,
                  match: Optional[dict] = None) -> list[dict]:
        """Exemplars carried through fresh sources for ``family``'s
        bucket series (label-subset filtered): ``{source, series, le,
        value, labels, ts}`` entries, the same shape the in-process
        ``Histogram.exemplars`` read produces — so the SLO evaluator's
        breach-forensics lookup works over a federated view too."""
        match_items = set((k, str(v)) for k, v in (match or {}).items())
        with self._lock:
            fresh = self._fresh(now)
        out = []
        for src_name, src in fresh:
            for (name, labels), exemplar in src.exemplars.items():
                if name != family + "_bucket":
                    continue
                series = dict(labels)
                le = series.pop("le", None)
                if not match_items <= set(
                        (k, str(v)) for k, v in series.items()):
                    continue
                out.append({
                    "source": src_name, "series": series,
                    "le": (math.inf if le == "+Inf"
                           else float(le) if le else None),
                    "value": exemplar["value"],
                    "labels": dict(exemplar["labels"]),
                    "ts": exemplar.get("ts"),
                })
        return out

    def breach_exemplars(self, family: str, labels: Optional[dict],
                         threshold: float, k: int,
                         now: Optional[float] = None) -> list[dict]:
        """The federated counterpart of ``obs.slo.registry_exemplars``
        — same (family, labels, threshold, k) lookup signature, so a
        central evaluator over remote replicas' OpenMetrics scrapes
        wires it in as ``SLOEvaluator(..., exemplar_lookup=
        aggregator.breach_exemplars)``: top-``k`` carried exemplars by
        value over ``threshold``. ``now`` defaults to the wall clock
        (the production adapter; tests pass it explicitly)."""
        import time

        found = self.exemplars(family,
                               time.time() if now is None else now,
                               match=labels)
        over = [e for e in found if e["value"] > threshold]
        return sorted(over, key=lambda e: -e["value"])[:max(0, int(k))]
