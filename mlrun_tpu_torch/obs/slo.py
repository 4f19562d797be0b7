"""Declarative SLOs with fast+slow multi-window burn-rate evaluation —
the port's own copy of ``mlrun_tpu/obs/slo.py`` (same objectives, budgets,
windows and thresholds, so the same store gives the same burn rates).

An objective declares what "good" means (p95 TTFT under a target,
dispatch error rate under a budget, availability over a floor); the
evaluator turns the time-series store into burn rates — how fast the
error budget is being consumed relative to steady state — over a FAST
window (catches a sharp regression in seconds) and a SLOW window
(confirms it is not a blip). A breach needs BOTH windows over their
thresholds. :meth:`SLOEvaluator.process` pushes each confirmed breach
through the port's ``service/alerts.process_event`` over a run db (alert
configs, silence windows and notification fan-out as the reference's),
re-firing a sustained breach at most every ``refire_after`` seconds.

Burn-rate definitions (budget = allowed bad fraction):

- ``latency``: objective "q-quantile of ``family`` ≤ ``target``
  seconds". Budget is ``1 - q`` (a p95 objective tolerates 5% of
  requests over target); the observed bad fraction is the windowed
  fraction of histogram observations above ``target``.
- ``error_rate``: objective "``bad`` events / ``total`` events ≤
  ``target``". Budget is ``target`` itself.
- ``availability``: objective "good / total ≥ ``target``" — an
  error-rate objective with budget ``1 - target``.
- ``goodput``: objective "goodput fraction ≥ ``target``" over the
  run-lifecycle accounting families (``obs/goodput.py``): bad defaults
  to ``mlt_badput_seconds_total`` and total to
  ``mlt_goodput_wall_seconds_total``, budget is ``1 - target`` (a 0.9
  goodput floor tolerates 10% badput seconds). ``run=`` narrows the
  objective to one run's series; ``bad_labels={"bucket": ...}``
  narrows to one badput class (e.g. alert on preemption downtime
  alone). Evaluation rides the same windowed-increase path as
  ``error_rate`` — nothing below this constructor changes.
- ``quality_delta``: objective "a gauge statistic under
  ``canary_labels`` must not degrade more than ``target`` against the
  same statistic under ``labels``" — the canary-vs-stable comparison
  behind the continuous-tuning loop (docs/continuous_tuning.md), over
  the per-adapter ``mlt_drift_stat`` series by default. Budget is 1.0
  so ``burn == windowed degradation / target``: burn 1.0 means the
  canary is worse by exactly the allowed delta; burn 0 means at least
  as good. ``direction`` says which way is worse for the statistic
  (``"higher_worse"`` — e.g. a drift score — or ``"lower_worse"`` —
  e.g. a confidence/quality mean). Either side's window being empty is
  "no signal", never a verdict.

``burn = bad_fraction / budget``; burn 1.0 = exactly on budget.

Stdlib-only at module level (``from_mlconf`` / ``process`` lazy-import
the config and the alert machinery).
"""

from __future__ import annotations

import threading
from typing import Callable, Iterable, Optional

from .flight import record as flight_record
from .metrics import REGISTRY


def registry_exemplars(family: str, labels: Optional[dict],
                       threshold: float, k: int) -> list[dict]:
    """Default breach-forensics lookup: the top-``k`` exemplars by value
    from the in-process registry histogram's offending buckets (value
    over ``threshold``, label-subset filtered) — the trace ids an SLO
    breach names (docs/observability.md "Request attribution, exemplars
    & trace assembly"). A federated evaluator passes
    ``MetricsAggregator.exemplars``-backed lookup instead."""
    metric = REGISTRY.get(family)
    exemplar_read = getattr(metric, "exemplars", None)
    if exemplar_read is None:
        return []
    found = exemplar_read(match=labels)
    over = [e for e in found if e["value"] > threshold]
    return sorted(over, key=lambda e: -e["value"])[:max(0, int(k))]

SLO_BURN_RATE = REGISTRY.gauge(
    "mlt_slo_burn_rate",
    "Error-budget burn rate per objective and window (1.0 = consuming "
    "budget exactly at the allowed steady-state rate)",
    labels=("slo", "window"), overflow="drop")
SLO_STATUS = REGISTRY.gauge(
    "mlt_slo_status",
    "Objective state: 0 ok, 1 fast-window burning (unconfirmed), "
    "2 breach (fast AND slow windows over threshold)",
    labels=("slo",), overflow="drop")
SLO_BREACHES = REGISTRY.counter(
    "mlt_slo_breaches_total",
    "Multi-window burn-rate breaches emitted to the alert machinery",
    labels=("slo",), overflow="drop")

_KINDS = ("latency", "error_rate", "availability", "goodput",
          "quality_delta")

# default event kind SLO breaches are emitted under — alert configs list
# it in trigger_events (see service/alerts.ALERT_TEMPLATES["SLOBurnRate"])
SLO_EVENT_KIND = "slo_burn_rate"


class SLO:
    """One declarative objective. ``family``/``bad``/``total`` name
    metric families in the time-series store; ``labels`` narrows the
    series the objective evaluates over (e.g. one engine)."""

    def __init__(self, name: str, kind: str, target: float,
                 family: str = "mlt_llm_ttft_seconds", q: float = 0.95,
                 bad: str = "mlt_fleet_dispatches_total",
                 bad_labels: Optional[dict] = None,
                 total: str = "mlt_fleet_dispatches_total",
                 total_labels: Optional[dict] = None,
                 labels: Optional[dict] = None,
                 severity: str = "high",
                 adapter: Optional[str] = None,
                 run: Optional[str] = None,
                 canary_labels: Optional[dict] = None,
                 direction: str = "higher_worse"):
        if kind not in _KINDS:
            raise ValueError(f"unknown SLO kind '{kind}' (one of {_KINDS})")
        if kind == "quality_delta":
            # like the goodput sugar: swap the latency-family default
            # for the drift-stat gauges the comparison is documented
            # over — an explicit family= still wins
            if family == "mlt_llm_ttft_seconds":
                family = "mlt_drift_stat"
            if not canary_labels:
                raise ValueError(
                    "quality_delta SLO needs canary_labels (the series "
                    "compared against the stable-side labels)")
            if dict(canary_labels) == dict(labels or {}):
                raise ValueError(
                    "quality_delta SLO canary_labels must differ from "
                    "labels — identical sides always read delta 0")
            if direction not in ("higher_worse", "lower_worse"):
                raise ValueError(
                    f"quality_delta direction must be 'higher_worse' or "
                    f"'lower_worse', got '{direction}'")
            if target <= 0:
                raise ValueError(
                    "quality_delta SLO target (allowed degradation) "
                    "must be > 0")
        elif canary_labels is not None:
            raise ValueError(
                "canary_labels is quality_delta-only sugar")
        if kind == "goodput":
            # goodput sugar: swap the serving-path default counters for
            # the run-lifecycle accounting families and fold a run=
            # filter into both sides; from here down the objective is an
            # ordinary windowed-increase ratio (the error_rate path)
            if bad == "mlt_fleet_dispatches_total":
                bad = "mlt_badput_seconds_total"
            if total == "mlt_fleet_dispatches_total":
                total = "mlt_goodput_wall_seconds_total"
            if run is not None:
                bad_labels = {**(bad_labels or {}), "run": run}
                total_labels = {**(total_labels or {}), "run": run}
        elif run is not None:
            raise ValueError(
                "run= is goodput-only sugar; other kinds take explicit "
                "bad_labels/total_labels")
        if adapter is not None:
            # per-tenant objective sugar (docs/observability.md "SLOs &
            # burn rates"): fold the adapter id into the latency-family
            # label filter so the windows evaluate ONE tenant's series —
            # a breaching tenant pages without painting its neighbors
            # red. Latency-only: the TTFT/ITL families carry the
            # adapter label; the default error-rate/availability
            # counters (fleet dispatches) do NOT, and silently matching
            # zero series would disable the objective — counter kinds
            # must put the adapter into bad_labels/total_labels against
            # a family that actually carries it.
            if kind != "latency":
                raise ValueError(
                    f"adapter= is latency-only sugar; a per-tenant "
                    f"{kind} SLO needs explicit bad_labels/total_labels "
                    f"over adapter-labeled families")
            labels = {**(labels or {}), "adapter": adapter}
        if kind == "latency":
            if not 0 < q < 1:
                raise ValueError(f"latency SLO needs 0 < q < 1, got {q}")
            if target <= 0:
                raise ValueError("latency SLO target must be > 0 seconds")
        elif kind != "quality_delta" and not 0 < target < 1:
            raise ValueError(
                f"{kind} SLO target must be a fraction in (0, 1)")
        if kind not in ("latency", "quality_delta") and bad == total \
                and dict(bad_labels or {}) == dict(total_labels or {}):
            # bad/total over the identical series is always 1.0 — a
            # constant max-burn false breach, never a real objective
            raise ValueError(
                f"{kind} SLO needs bad_labels (or a distinct bad "
                f"family) to tell bad events apart from the total")
        self.name = name
        self.kind = kind
        self.target = float(target)
        self.family = family
        self.q = float(q)
        self.bad = bad
        self.bad_labels = dict(bad_labels or {})
        self.total = total
        self.total_labels = dict(total_labels or {})
        self.labels = dict(labels or {})
        self.severity = severity
        self.adapter = adapter
        self.run = run
        self.canary_labels = dict(canary_labels or {})
        self.direction = direction

    @classmethod
    def from_config(cls, config: dict) -> "SLO":
        known = ("name", "kind", "target", "family", "q", "bad",
                 "bad_labels", "total", "total_labels", "labels",
                 "severity", "adapter", "run", "canary_labels",
                 "direction")
        unknown = set(config) - set(known)
        if unknown:
            raise ValueError(
                f"unknown SLO objective keys: {sorted(unknown)}")
        return cls(**config)

    @property
    def budget(self) -> float:
        """Allowed bad fraction."""
        if self.kind == "latency":
            return 1.0 - self.q
        if self.kind in ("availability", "goodput"):
            return 1.0 - self.target
        if self.kind == "quality_delta":
            # burn == bad_fraction == degradation / target directly:
            # burn 1.0 = the canary is worse by exactly the allowed delta
            return 1.0
        return self.target

    def _window_mean(self, store, window: float, at: float,
                     labels: dict) -> Optional[float]:
        """Mean of one side's windowed gauge points (bucket-avg, then
        time-avg) — None when the window carries no points."""
        pts = store.points(self.family, at - window, at,
                           labels=labels or None, agg="avg")
        if not pts:
            return None
        return sum(v for _, v in pts) / len(pts)

    def bad_fraction(self, store, window: float,
                     at: float) -> Optional[float]:
        """Observed bad fraction over ``window`` — None when the window
        carries no signal (an empty window neither burns nor clears)."""
        if self.kind == "latency":
            return store.fraction_over(self.family, self.target, window,
                                       at, labels=self.labels or None)
        if self.kind == "quality_delta":
            stable = self._window_mean(store, window, at, self.labels)
            canary = self._window_mean(store, window, at,
                                       self.canary_labels)
            if stable is None or canary is None:
                return None
            delta = canary - stable
            if self.direction == "lower_worse":
                delta = -delta
            # deliberately NOT clamped to 1.0: burn must be able to
            # exceed the evaluator's thresholds (the global evaluator
            # runs fast_burn 14.4 / slow_burn 6.0 — a capped burn could
            # never breach there no matter how bad the canary got)
            return max(0.0, delta / self.target)
        total = store.increase(self.total, window, at,
                               labels=self.total_labels or None)
        if total <= 0:
            return None
        bad = store.increase(self.bad, window, at,
                             labels=self.bad_labels or None)
        return max(0.0, min(1.0, bad / total))

    def describe(self) -> dict:
        out = {"name": self.name, "kind": self.kind, "target": self.target,
               "budget": self.budget, "severity": self.severity}
        if self.adapter is not None:
            out["adapter"] = self.adapter
        if self.run is not None:
            out["run"] = self.run
        if self.kind == "latency":
            out.update(family=self.family, q=self.q)
        elif self.kind == "quality_delta":
            out.update(family=self.family, direction=self.direction,
                       canary_labels=self.canary_labels)
        else:
            out.update(bad=self.bad, total=self.total)
        return out


class SLOStatus(dict):
    """Evaluation result — a plain dict (JSON-friendly for the status
    endpoints) with attribute sugar for the hot keys."""

    @property
    def breaching(self) -> bool:
        return bool(self["breaching"])

    @property
    def burn_fast(self) -> Optional[float]:
        return self["burn"]["fast"]

    @property
    def burn_slow(self) -> Optional[float]:
        return self["burn"]["slow"]


class SLOEvaluator:
    """Evaluates objectives against a :class:`TimeSeriesStore` and
    pushes confirmed breaches through the alert machinery."""

    def __init__(self, store, slos: Iterable[SLO] = (),
                 fast_window: float = 60.0, slow_window: float = 300.0,
                 fast_burn: float = 14.4, slow_burn: float = 6.0,
                 refire_after: float = 0.0, project: str = "",
                 exemplar_lookup: Optional[Callable] = None,
                 exemplar_k: int = 3):
        if fast_window <= 0 or slow_window <= fast_window:
            raise ValueError("need 0 < fast_window < slow_window")
        self.store = store
        self.slos = list(slos)
        self.fast_window = float(fast_window)
        self.slow_window = float(slow_window)
        self.fast_burn = float(fast_burn)
        self.slow_burn = float(slow_burn)
        self.refire_after = float(refire_after)
        self.project = project
        # (family, labels, threshold, k) -> worst-offender exemplars; a
        # confirmed breach attaches these so the alert names trace ids
        self.exemplar_lookup = exemplar_lookup or registry_exemplars
        self.exemplar_k = int(exemplar_k)
        self._lock = threading.Lock()
        self._last: list[SLOStatus] = []
        self._fired_at: dict[str, float] = {}  # slo name -> last fire t

    @classmethod
    def from_mlconf(cls, store, slos: Iterable[SLO] = None,
                    project: str = "",
                    exemplar_lookup: Optional[Callable] = None
                    ) -> "SLOEvaluator":
        """An evaluator on ``config.OBSERVABILITY_DEFAULTS["slo"]`` (its
        windows, burn thresholds, refire bound and objectives)."""
        from ..config import OBSERVABILITY_DEFAULTS

        conf = OBSERVABILITY_DEFAULTS["slo"]
        if slos is None:
            slos = [SLO.from_config(dict(obj))
                    for obj in (conf["objectives"] or [])]
        return cls(store, slos,
                   fast_window=float(conf["fast_window_s"]),
                   slow_window=float(conf["slow_window_s"]),
                   fast_burn=float(conf["fast_burn"]),
                   slow_burn=float(conf["slow_burn"]),
                   refire_after=float(conf["refire_after_s"]),
                   project=project,
                   exemplar_lookup=exemplar_lookup)

    def evaluate(self, at: float) -> list[SLOStatus]:
        """Burn rates for every objective at ``at``. Breach = fast AND
        slow windows over their thresholds; fast-only = "burning"
        (unconfirmed, surfaced but not alerted)."""
        out = []
        for slo in self.slos:
            burns = {}
            for window_name, window, threshold in (
                    ("fast", self.fast_window, self.fast_burn),
                    ("slow", self.slow_window, self.slow_burn)):
                frac = slo.bad_fraction(self.store, window, at)
                burn = (frac / slo.budget) if frac is not None else None
                burns[window_name] = burn
                # an empty window exports 0, not the last value — a
                # stale breach-level gauge after traffic stops would
                # contradict mlt_slo_status forever
                SLO_BURN_RATE.set(burn if burn is not None else 0.0,
                                  slo=slo.name, window=window_name)
            fast_over = (burns["fast"] is not None
                         and burns["fast"] >= self.fast_burn)
            slow_over = (burns["slow"] is not None
                         and burns["slow"] >= self.slow_burn)
            breaching = fast_over and slow_over
            status = SLOStatus(slo.describe())
            status.update(
                burn=burns, burning=fast_over, breaching=breaching,
                thresholds={"fast": self.fast_burn,
                            "slow": self.slow_burn},
                windows={"fast": self.fast_window,
                         "slow": self.slow_window},
                at=at)
            SLO_STATUS.set(2 if breaching else 1 if fast_over else 0,
                           slo=slo.name)
            out.append(status)
        with self._lock:
            self._last = out
        return out

    def status(self) -> list[SLOStatus]:
        """Last evaluation (the cheap read the smoke/status endpoints
        use; empty before the first evaluate())."""
        with self._lock:
            return list(self._last)

    def process(self, db, at: float, project: str = None) -> list:
        """Evaluate and push each confirmed breach through
        ``service/alerts.process_event`` — the event is also persisted
        via ``db.emit_event`` first so count-over-period criteria see
        it. Returns the names of alert configs that fired (an active
        silence window keeps a breach out of this list — silencing is
        ``process_event``'s job, not re-implemented here). A SUSTAINED
        breach re-fires only every ``refire_after`` seconds (0 = every
        call): the service loop evaluates every few seconds, and one
        long incident must not page once per tick. Recovery resets the
        damper, so a fresh incident fires immediately."""
        from ..service.alerts import process_event

        project = self.project if project is None else project
        slos_by_name = {slo.name: slo for slo in self.slos}
        fired = []
        for status in self.evaluate(at):
            if not status.breaching:
                self._fired_at.pop(status["name"], None)
                continue
            last = self._fired_at.get(status["name"])
            if last is not None and self.refire_after > 0 \
                    and at - last < self.refire_after:
                continue
            self._fired_at[status["name"]] = at
            SLO_BREACHES.inc(slo=status["name"])
            event = {"entity_id": status["name"],
                     "slo": status["name"], "kind": status["kind"],
                     "severity": status["severity"],
                     "burn_fast": status.burn_fast,
                     "burn_slow": status.burn_slow,
                     "target": status["target"]}
            exemplar_ids: list[str] = []
            slo = slos_by_name.get(status["name"])
            if slo is not None and slo.kind == "latency":
                # the breach window's worst offenders, lifted off the
                # offending histogram buckets: the alert payload and the
                # flight-recorder entry now NAME trace ids a
                # `/debug/trace/<id>` fetch turns into a waterfall
                try:
                    worst = self.exemplar_lookup(
                        slo.family, slo.labels or None, slo.target,
                        self.exemplar_k)
                except Exception:  # noqa: BLE001 - forensics must not
                    worst = []     # block the alert itself
                if worst:
                    event["exemplars"] = [
                        {"value": e["value"], **e["labels"]}
                        for e in worst]
                    exemplar_ids = [e["labels"].get("trace_id")
                                    for e in worst
                                    if e["labels"].get("trace_id")]
            flight_record("slo.breach", slo=status["name"],
                          slo_kind=status["kind"],
                          burn_fast=status.burn_fast,
                          burn_slow=status.burn_slow,
                          exemplar_trace_ids=exemplar_ids)
            db.emit_event(SLO_EVENT_KIND, event, project)
            fired.extend(process_event(db, project, SLO_EVENT_KIND, event))
        return fired
