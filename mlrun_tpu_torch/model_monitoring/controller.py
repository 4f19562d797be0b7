"""Monitoring controller + writer — the port's copy of ``mlrun_tpu/
model_monitoring/controller.py``: ``ModelMonitoringWriter`` (application
results onto model-endpoint records, the metric series and alert events),
``MonitoringApplicationController`` (the windowed batch runner over the
endpoint parquet) and ``ContinuousTuningController`` (the closed
drift → LoRA retrain run → canary → promote / rollback loop over a
serving engine or fleet).

pandas is imported only where a frame is built (``run_once`` and
``_inputs_frame``), so the continuous-tuning loop imports and runs on a
machine without pandas."""

from __future__ import annotations

import json
import os
from typing import TYPE_CHECKING, Optional

from ..common.journal import open_journal
from ..config import (
    MODEL_MONITORING_DEFAULTS,
    resolve_artifact_path,
    run_config,
)
from ..utils import logger
from ..utils.helpers import now_iso
from .applications import (
    ApplicationResult,
    HistogramDataDriftApplication,
    LatencyApplication,
    ModelMonitoringApplicationBase,
    MonitoringContext,
)
from .stream_processing import (
    EventStreamProcessor,
    get_monitoring_parquet_dir,
)

if TYPE_CHECKING:
    import pandas as pd


class ModelMonitoringWriter:
    """Persist application results onto model-endpoint records + emit
    events for alerting (reference writer.py:54,98)."""

    def __init__(self, project: str, db=None):
        self.project = project
        if db is None:
            from ..db import get_run_db

            db = get_run_db()
        self.db = db

    def write(self, endpoint_id: str, results: list[ApplicationResult]):
        try:
            record = self.db.get_model_endpoint(self.project, endpoint_id)
        except Exception:  # noqa: BLE001
            record = {"uid": endpoint_id, "project": self.project,
                      "metrics": {}}
        metrics = record.setdefault("metrics", {})
        drift_status = record.get("drift_status", "")
        for result in results:
            metrics[result.name] = result.value
            if result.kind == "drift":
                drift_status = result.status
                record["drift_measures"] = result.extra.get("per_feature", {})
            if result.status == "detected":
                try:
                    self.db.emit_event(
                        "model_drift_detected" if result.kind == "drift"
                        else "model_anomaly",
                        {"endpoint_id": endpoint_id, "metric": result.name,
                         "value": result.value}, self.project)
                except Exception:  # noqa: BLE001
                    pass
        record["drift_status"] = drift_status
        record["last_analyzed"] = now_iso()
        self.db.store_model_endpoint(self.project, endpoint_id, record)
        # append every numeric result to the metric time-series so drift /
        # latency history is queryable with time ranges (tsdb.py)
        try:
            from .tsdb import get_metrics_tsdb

            get_metrics_tsdb().write(
                self.project, endpoint_id,
                {r.name: r.value for r in results})
        except Exception:  # noqa: BLE001 - series write is best-effort
            pass


class MonitoringApplicationController:
    """Drive monitoring apps over windowed inference parquet."""

    def __init__(self, project: str,
                 applications: list[ModelMonitoringApplicationBase]
                 | None = None, db=None, max_window_rows: int = 100_000):
        self.project = project
        # windows larger than max_window_rows skip dataframe expansion and
        # run drift from the stream processor's fixed-memory histogram
        # sketches instead (high-cardinality / high-volume endpoints)
        self.max_window_rows = max_window_rows
        self.applications = applications or [
            HistogramDataDriftApplication(), LatencyApplication()]
        if db is None:
            from ..db import get_run_db

            db = get_run_db()
        self.db = db
        self.processor = EventStreamProcessor(project, db=db)
        self.writer = ModelMonitoringWriter(project, db=db)
        self._processed_rows: dict[str, int] = {}

    def _reference_df(self, endpoint: dict) -> Optional[pd.DataFrame]:
        """Training-set sample from the registered model artifact."""
        model_uri = endpoint.get("model_uri") or endpoint.get("model", "")
        if not model_uri:
            return None
        try:
            from ..datastore import store_manager

            item = store_manager.object(url=model_uri)
            meta = item.meta or {}
            sample = meta.get("spec", {}).get("sample_set_path")
            if sample:
                return store_manager.object(url=sample).as_df()
        except Exception:  # noqa: BLE001
            return None
        return None

    def run_once(self) -> dict:
        """Drain stream → window per endpoint → run apps → write results."""
        import pandas as pd

        self.processor.run_once()
        # apply series retention each pass so metrics.db stays bounded
        try:
            from .tsdb import get_metrics_tsdb

            retention_days = float(
                MODEL_MONITORING_DEFAULTS["tsdb_retention_days"])
            if retention_days > 0:
                get_metrics_tsdb().prune(retention_days * 86400.0)
        except Exception:  # noqa: BLE001 - retention is best-effort
            pass
        results_by_endpoint: dict[str, list] = {}
        parquet_dir = get_monitoring_parquet_dir(self.project)
        if not os.path.isdir(parquet_dir):
            return results_by_endpoint
        for fname in os.listdir(parquet_dir):
            if not fname.endswith(".parquet"):
                continue
            endpoint_id = fname[:-len(".parquet")]
            df = pd.read_parquet(os.path.join(parquet_dir, fname))
            start_row = self._processed_rows.get(endpoint_id, 0)
            window = df.iloc[start_row:]
            if window.empty:
                continue
            self._processed_rows[endpoint_id] = len(df)
            if len(window) > self.max_window_rows:
                # too big to expand row-by-row — drift runs from the
                # streamed histogram sketches instead
                sample_df = pd.DataFrame()
                if not self.processor.load_histograms(endpoint_id):
                    # e.g. restart with a parquet backlog: sketches are
                    # in-memory only, so this window cannot get drift
                    logger.warning(
                        "window exceeds max_window_rows and no sketches "
                        "are available — drift skipped for this window",
                        endpoint=endpoint_id, rows=len(window))
            else:
                try:
                    sample_df = _inputs_frame(window)
                except Exception as exc:  # noqa: BLE001 - bad rows skip
                    logger.warning("could not parse inputs window",
                                   endpoint=endpoint_id, error=str(exc))
                    continue
            try:
                endpoint = self.db.get_model_endpoint(self.project,
                                                      endpoint_id)
            except Exception:  # noqa: BLE001
                endpoint = {}
            ctx = MonitoringContext(
                project=self.project, endpoint_id=endpoint_id,
                model_name=endpoint.get("name", ""),
                sample_df=sample_df,
                reference_df=self._reference_df(endpoint),
                start=str(window["when"].iloc[0]),
                end=str(window["when"].iloc[-1]),
                latencies_microsec=list(window["microsec"]),
                error_count=int(endpoint.get("error_count", 0)),
                # only consulted when sample_df is empty (window too big)
                sample_histograms=(
                    self.processor.load_histograms(endpoint_id)
                    if sample_df.empty else {}))
            all_results: list[ApplicationResult] = []
            for app in self.applications:
                try:
                    all_results.extend(app.do_tracking(ctx) or [])
                except Exception as exc:  # noqa: BLE001
                    logger.warning("monitoring app failed", app=app.name,
                                   error=str(exc))
            if all_results:
                self.writer.write(endpoint_id, all_results)
            results_by_endpoint[endpoint_id] = all_results
            # next window's sketches start fresh
            self.processor.reset_histograms(endpoint_id)
        return results_by_endpoint


def _inputs_frame(window: pd.DataFrame) -> pd.DataFrame:
    """Expand the json-encoded inputs column into a feature dataframe."""
    import pandas as pd

    rows = []
    for encoded in window["inputs"]:
        try:
            batch = json.loads(encoded)
        except (TypeError, ValueError):
            continue
        if isinstance(batch, list):
            for item in batch:
                if isinstance(item, list):
                    rows.append(item)
                elif isinstance(item, dict):
                    rows.append(item)
                else:
                    rows.append([item])
    if not rows:
        return pd.DataFrame()
    dict_rows = [r for r in rows if isinstance(r, dict)]
    list_rows = [r for r in rows if isinstance(r, list)]
    if dict_rows and not list_rows:
        return pd.DataFrame(dict_rows)
    if list_rows and dict_rows:
        # mixed shapes: name list positions f0.. and merge with dict rows
        list_rows = [
            {f"f{i}": v for i, v in enumerate(r)} for r in list_rows
        ]
        return pd.DataFrame(list_rows + dict_rows)
    width = max(len(r) for r in list_rows)
    return pd.DataFrame(
        [r + [None] * (width - len(r)) for r in list_rows],
        columns=[f"f{i}" for i in range(width)])


# -- continuous fine-tune→canary→promote loop (docs/continuous_tuning.md) ----
class _TenantState:
    """Per-tenant closed-loop state: drift hysteresis, the in-flight
    retrain (at most one — the debounce), and the active canary."""

    __slots__ = ("drift_streak", "version", "inflight", "canary",
                 "last_concluded_at", "last_drift_stats")

    def __init__(self):
        self.drift_streak = 0
        self.version = 0
        self.inflight: Optional[dict] = None
        self.canary: Optional[dict] = None
        self.last_concluded_at: Optional[float] = None
        self.last_drift_stats: dict = {}


def _version_of(canary_id: str) -> int:
    """The version a loop-managed ``<tenant>@v<n>`` id encodes (0 for
    anything else) — journal replay restores the per-tenant version
    counter from these so a restarted loop never re-mints an id."""
    _, sep, ver = (canary_id or "").partition("@v")
    if not sep:
        return 0
    try:
        return int(ver)
    except ValueError:
        return 0


class _AdoptedRun:
    """Run handle rebuilt from the run DB by uid after a controller
    restart — duck-types the one method the poll loop uses, so the ONE
    submitted retrain keeps its identity across the crash (no
    double-submit). A uid the DB no longer knows reads as ``error``:
    the poll concludes it and frees the tenant's debounce."""

    def __init__(self, db, project: str, uid: str):
        self._db = db
        self._project = project
        self.uid = uid

    def state(self) -> str:
        from ..model import RunStates

        run = self._db.read_run(self.uid, self._project)
        if not run:
            return RunStates.error
        return (run.get("status") or {}).get("state") \
            or RunStates.running


class ContinuousTuningController:
    """The closed MLOps loop: serving traffic → drift → LoRA fine-tune →
    canary → promote/rollback, with no human in the loop.

    One controller per serving handle (an ``EngineFleet`` or a single
    engine exposing ``add_adapter_source``/``retire_adapter``). The
    :meth:`tick` drives everything off an explicit ``now`` — the same
    interval-evaluator convention as ``service/autoscaler.py``: no
    hidden wall-clock reads, no sleeps, so the whole loop runs on a fake
    clock in tests and off any timer in production.

    Stages per tick:

    1. **observe** — drain the engines' sample tap
       (``serving/samples.py``) into the per-adapter
       :class:`~mlrun_tpu_torch.model_monitoring.stream_processing.AdapterTrafficMonitor`
       and snapshot the process metric families into the windowed
       time-series store (the federation path — per-adapter TTFT
       histograms land next to the drift stats).
    2. **detect** — evaluate every tracked adapter: windowed
       token/logit/output statistics export as ``mlt_drift_stat``; a
       PSI-over-threshold verdict on the tenant's CURRENT stable id
       advances the drift streak (``confirm_ticks`` of hysteresis; the
       ``monitor.drift`` chaos point makes this deterministically
       injectable).
    3. **retrain** — confirmed drift submits ONE ``tpujob`` LoRA
       fine-tune through the existing launcher path (retry/resume and
       goodput attribution ride the run lifecycle for free). Debounced:
       a tenant with an in-flight retrain or live canary never
       double-submits; ``cooldown_s`` spaces consecutive loops.
    4. **canary** — the finished run's adapter artifact hot-loads as
       ``<tenant>@v<n>`` and a deterministic hash split
       (``serving/canary.py``) sends ``fraction`` of the tenant's
       traffic to it — with canary-namespaced prefix/routing identity,
       so canary KV never serves stable traffic.
    5. **decide** — a multi-window burn-rate evaluator (``obs/slo.py``)
       compares canary-vs-stable per-adapter series: a latency objective
       over ``mlt_llm_ttft_seconds{adapter=<canary>}`` plus the
       ``quality_delta`` objective over ``mlt_drift_stat``. Sustained
       canary-better re-points the tenant's stable id at the new version
       (old factors evicted); sustained canary-worse rolls back and
       dumps a flight-recorder post-mortem carrying the full causal
       chain.
    """

    def __init__(self, serving, project: str = "", db=None,
                 store=None, aggregator=None, router=None, monitor=None,
                 ring=None, submit_fn=None, journal=None, **overrides):
        conf = MODEL_MONITORING_DEFAULTS["continuous"]

        def knob(section, name, cast=float, key=None):
            key = key or name
            if key in overrides:
                return cast(overrides.pop(key))
            return cast(section[name])

        self.serving = serving
        self.project = project or str(run_config("default_project"))
        self._db = db
        self.confirm_ticks = knob(conf["drift"], "confirm_ticks", int)
        retrain = conf["retrain"]
        self.retrain_kind = knob(retrain, "kind", str,
                                 key="retrain_kind")
        self.retrain_handler = overrides.pop(
            "retrain_handler", str(retrain["handler"]) or None)
        self.retrain_image = knob(retrain, "image", str,
                                  key="retrain_image")
        self.cooldown_s = knob(retrain, "cooldown_s")
        canary = conf["canary"]
        self.fraction = knob(canary, "fraction")
        self.warmup_s = knob(canary, "warmup_s")
        self.fast_window_s = knob(canary, "fast_window_s")
        self.slow_window_s = knob(canary, "slow_window_s")
        self.ttft_target_s = knob(canary, "ttft_target_s")
        self.ttft_q = knob(canary, "ttft_q")
        self.quality_target = knob(canary, "quality_target")
        self.quality_stat = knob(canary, "quality_stat", str)
        self.quality_direction = knob(canary, "quality_direction", str)
        self.promote_ticks = knob(canary, "promote_ticks", int)
        self.rollback_ticks = knob(canary, "rollback_ticks", int)
        self.promote_max_burn = knob(canary, "promote_max_burn")
        self.max_age_s = knob(canary, "max_age_s")
        # monitor knobs ride through to AdapterTrafficMonitor
        monitor_keys = {k: overrides.pop(k) for k in
                        ("vocab_size", "token_bins", "length_bins",
                         "max_output_len", "reference_min", "window_min",
                         "psi_threshold", "max_adapters")
                        if k in overrides}
        if overrides:
            raise ValueError(
                f"unknown continuous-tuning knobs: {sorted(overrides)}")
        from ..obs import MetricsAggregator, TimeSeriesStore
        from ..serving.canary import CanaryRouter
        from ..serving.samples import SampleRing
        from .stream_processing import AdapterTrafficMonitor

        self.store = store if store is not None \
            else TimeSeriesStore.from_mlconf()
        self.aggregator = aggregator if aggregator is not None \
            else MetricsAggregator()
        self.router = router or CanaryRouter()
        self.monitor = monitor or AdapterTrafficMonitor(**monitor_keys)
        self.ring = ring if ring is not None else SampleRing()
        self._submit = submit_fn or self._default_submit
        self._tenants: dict[str, _TenantState] = {}
        # DRIFT_STAT label sets emitted per adapter, so a retired
        # version's gauge series can be removed exactly
        self._stat_labels: dict[str, set] = {}
        self._observer = None
        self._started = False
        # durable canary journal + restart recovery (docs/
        # fault_tolerance.md "Control-plane crash recovery"); None =
        # journaling off (the default — zero behavior change)
        self._journal = journal if journal is not None \
            else open_journal("canary")
        if self._journal is not None:
            self._recover_from_journal()

    @property
    def db(self):
        if self._db is None:
            from ..db import get_run_db

            self._db = get_run_db()
        return self._db

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ContinuousTuningController":
        """Arm the engines' sample tap and install this controller's
        canary router as the process router the submit paths consult
        (latest controller wins the process slots)."""
        from ..serving.canary import set_canary_router
        from ..serving.samples import set_sample_observer

        self._observer = self.ring.append
        set_sample_observer(self._observer)
        set_canary_router(self.router)
        self._started = True
        return self

    def stop(self):
        from ..serving.canary import (
            get_canary_router,
            set_canary_router,
        )
        from ..serving.samples import (
            get_sample_observer,
            set_sample_observer,
        )

        if self._started:
            # clear the process slots only if this controller still owns
            # them — a later controller's start() replaced them, and
            # tearing ITS tap/router down would silently stop its
            # sampling and pass its canary traffic through unsplit
            if get_sample_observer() is self._observer:
                set_sample_observer(None)
            if get_canary_router() is self.router:
                set_canary_router(None)
            self._started = False

    def __enter__(self) -> "ContinuousTuningController":
        return self.start()

    def __exit__(self, *exc_info):
        self.stop()
        return False

    # -- durable intent + crash recovery -------------------------------------
    def _journal_append(self, **fields):
        if self._journal is None:
            return
        from ..obs import JOURNAL_WRITES

        ok = self._journal.append("canary", **fields)
        JOURNAL_WRITES.inc(journal="canary",
                           outcome="ok" if ok else "failed")

    def _journal_snapshot(self) -> list[dict]:
        """Compaction view: per tenant, the promoted alias (so stable
        resolution survives further restarts), the in-flight retrain,
        and the live canary — everything replay needs, nothing more."""
        records: list[dict] = []
        for tenant, state in self._tenants.items():
            alias = self.router.stable_id(tenant)
            if alias != tenant:
                records.append({"kind": "canary", "op": "promote",
                                "tenant": tenant, "canary_id": alias,
                                "at": state.last_concluded_at or 0.0})
            elif state.last_concluded_at is not None:
                records.append({"kind": "canary", "op": "concluded",
                                "tenant": tenant,
                                "at": state.last_concluded_at})
            if state.inflight is not None:
                records.append({
                    "kind": "canary", "op": "retrain", "tenant": tenant,
                    "uid": state.inflight.get("uid", ""),
                    "canary_id": state.inflight.get("canary_id", ""),
                    "output_path": state.inflight.get("output_path", ""),
                    "version": state.version,
                    "at": state.inflight.get("submitted_at", 0.0)})
            if state.canary is not None:
                records.append({
                    "kind": "canary", "op": "canary", "tenant": tenant,
                    "canary_id": state.canary["id"],
                    "fraction": state.canary.get("fraction",
                                                 self.fraction),
                    "output_path": state.canary.get("output_path", ""),
                    "started": state.canary["started"]})
        return records

    def _recover_from_journal(self):
        """Rebuild the closed loop from the intent journal — preserving
        the debounce (in-flight retrain / live canary / cooldown), the
        version counter, and the canary's START time (so ``max_age_s``
        still concludes it — no canary pinned forever). The run DB is
        not touched here: the adopted retrain re-attaches by uid lazily
        on the first poll tick. A re-installed split is hash-identical
        by construction: ``CanaryRouter.bucket`` is a pure sha256 of
        (tenant, request key), and the canary id + fraction come back
        from the journal."""
        from ..obs import CANARY_STATE, RECONCILE_ACTIONS, flight_record

        records = [r for r in self._journal.replay()
                   if r.get("kind") == "canary" and r.get("tenant")]
        if not records:
            return
        for rec in records:
            tenant = rec["tenant"]
            state = self._tenants.setdefault(tenant, _TenantState())
            state.version = max(
                state.version, int(rec.get("version", 0) or 0),
                _version_of(rec.get("canary_id", "")))
            op = rec.get("op")
            if op == "retrain":
                state.inflight = {
                    "run": None,  # re-attached by uid on the first poll
                    "uid": rec.get("uid", ""),
                    "canary_id": rec.get("canary_id", ""),
                    "output_path": rec.get("output_path", ""),
                    "submitted_at": rec.get("at", 0.0)}
            elif op == "canary":
                state.inflight = None
                state.canary = {
                    "id": rec.get("canary_id", ""),
                    "started": rec.get("started", 0.0),
                    "fraction": float(rec.get("fraction",
                                              self.fraction)),
                    "output_path": rec.get("output_path", ""),
                    "evaluator": None, "better": 0, "worse": 0}
            elif op == "promote":
                if state.canary is not None \
                        and state.canary["id"] == rec.get("canary_id"):
                    state.canary = None
                self.router.set_alias(tenant, rec.get("canary_id", ""))
                state.last_concluded_at = rec.get("at")
            elif op in ("rollback", "concluded"):
                state.canary = None
                state.inflight = None
                state.last_concluded_at = rec.get("at")
        splits = retrains = 0
        for tenant, state in self._tenants.items():
            if state.canary is not None:
                canary_id = state.canary["id"]
                if state.canary.get("output_path"):
                    try:
                        self.serving.add_adapter_source(
                            canary_id, state.canary["output_path"])
                    except Exception as exc:  # noqa: BLE001 - the split
                        # still installs; a missing artifact surfaces as
                        # per-request adapter errors, not a dead loop
                        logger.warning("adopted canary source failed",
                                       tenant=tenant, canary=canary_id,
                                       error=str(exc))
                self.router.set_split(tenant, canary_id,
                                      state.canary["fraction"])
                # burn counters restart clean: a verdict needs fresh
                # consecutive windows on this side of the restart
                state.canary["evaluator"] = self._canary_evaluator(
                    tenant, canary_id)
                CANARY_STATE.set(1, adapter=tenant)
                splits += 1
                RECONCILE_ACTIONS.inc(controller="canary",
                                      action="adopt_split")
                flight_record("reconcile.adopt", tenant=tenant,
                              canary=canary_id,
                              fraction=state.canary["fraction"],
                              what="canary_split")
            if state.inflight is not None:
                retrains += 1
                RECONCILE_ACTIONS.inc(controller="canary",
                                      action="adopt_retrain")
                flight_record("reconcile.resume", tenant=tenant,
                              uid=state.inflight["uid"],
                              what="retrain_run")
        flight_record("reconcile.converged", controller="canary",
                      splits=splits, retrains=retrains)
        logger.info("continuous-tuning loop recovered from journal",
                    tenants=len(self._tenants), splits=splits,
                    retrains=retrains)
        self._journal.compact(self._journal_snapshot())

    # -- the tick ------------------------------------------------------------
    def tick(self, now: float) -> dict:
        """One closed-loop evaluation at ``now``. Deterministic — no
        internal clock reads, no sleeps; everything time-dependent
        (windows, cooldowns, canary warmup) keys on the caller's
        clock."""
        from ..obs import REGISTRY
        from ..utils import logger

        out = {"now": now, "evaluated": {}, "actions": []}
        for sample in self.ring.drain():
            self.monitor.observe(sample)
        evaluated = []
        for adapter in self.monitor.adapters():
            stats, drifted = self.monitor.evaluate(adapter, now)
            self._record_stats(adapter, stats)
            out["evaluated"][adapter] = {"stats": stats,
                                         "drifted": drifted}
            evaluated.append((adapter, stats, drifted))
        # federate this process's families (per-adapter TTFT histograms,
        # the DRIFT_STAT gauges just updated above, canary counters)
        # into the windowed store the SLO evaluator and the grafana
        # endpoints read — the same path the service loop uses, and the
        # ONE store write per drift-stat series this tick
        try:
            self.aggregator.ingest_text(
                "continuous-tuning", REGISTRY.render(), now)
            self.aggregator.snapshot_to(self.store, now)
        except Exception as exc:  # noqa: BLE001 - monitoring must not die
            logger.warning("continuous-tuning metrics ingest failed",
                           error=str(exc))
        for adapter, stats, drifted in evaluated:
            if not adapter:
                # adapterless/base-model traffic ("" samples) is
                # monitored for telemetry but has no adapter to retrain
                # — it must never reach the drift state machine
                continue
            tenant = adapter.split("@", 1)[0]
            if adapter != self.router.stable_id(tenant):
                # canary / stale versioned ids carry no drift state
                # machine of their own — their stats feed the
                # quality_delta comparison only
                continue
            self._drift_machine(tenant, stats, drifted, now, out)
        for tenant, state in list(self._tenants.items()):
            if state.inflight is not None:
                self._poll_retrain(tenant, state, now, out)
            if state.canary is not None:
                self._evaluate_canary(tenant, state, now, out)
        return out

    def _record_stats(self, adapter: str, stats: dict):
        """Export the stats on the DRIFT_STAT gauge — the tick's
        aggregator snapshot (which runs AFTER evaluation) lands them in
        the windowed store exactly once."""
        from ..obs import DRIFT_STAT

        seen = self._stat_labels.setdefault(adapter, set())
        for key, value in stats.items():
            if isinstance(value, (int, float)):
                DRIFT_STAT.set(float(value), adapter=adapter, stat=key)
                seen.add(key)

    def _retire_series(self, adapter: str):
        """Drop a dead versioned id's series from the windowed store AND
        the DRIFT_STAT gauge — version churn must not fill
        ``max_series``/``max_label_sets`` with retired adapters until
        every NEW canary's series silently stop recording (the same
        retire-on-scale-down rule as service/autoscaler.py)."""
        from ..obs import DRIFT_STAT

        self.store.drop_series(labels={"adapter": adapter})
        for stat in self._stat_labels.pop(adapter, set()):
            DRIFT_STAT.remove(adapter=adapter, stat=stat)

    # -- stage: drift state machine ------------------------------------------
    def _drift_machine(self, tenant: str, stats: dict, drifted,
                       now: float, out: dict):
        from ..obs import DRIFT_EVENTS, flight_record

        state = self._tenants.setdefault(tenant, _TenantState())
        if drifted:
            DRIFT_EVENTS.inc(adapter=tenant, event="detected")
            state.drift_streak += 1
            state.last_drift_stats = dict(stats)
        elif drifted is False:
            state.drift_streak = 0
        # drifted None = window still filling: hold the streak
        if state.drift_streak < self.confirm_ticks:
            return
        if state.inflight is not None or state.canary is not None:
            # debounce: one in-flight retrain per tenant — a second
            # confirmed drift while tuning/canarying must not stack jobs
            return
        if state.last_concluded_at is not None \
                and now - state.last_concluded_at < self.cooldown_s:
            return
        state.drift_streak = 0
        DRIFT_EVENTS.inc(adapter=tenant, event="confirmed")
        flight_record("monitor.drift_confirmed", adapter=tenant,
                      stats={k: v for k, v in stats.items()
                             if isinstance(v, (int, float))}, at=now)
        self._submit_retrain(tenant, state, stats, now, out)

    # -- stage: trigger → fine-tune ------------------------------------------
    def _artifact_path(self, tenant: str, version: int) -> str:
        base = resolve_artifact_path(self.project)
        directory = os.path.join(base, "tuned-adapters")
        if "://" not in directory:
            os.makedirs(directory, exist_ok=True)
        return os.path.join(directory, f"{tenant}-v{version}.npz")

    def _submit_retrain(self, tenant: str, state: _TenantState,
                        stats: dict, now: float, out: dict):
        from ..obs import DRIFT_EVENTS, flight_record
        from ..utils import logger

        state.version += 1
        canary_id = f"{tenant}@v{state.version}"
        request = {
            "tenant": tenant,
            "base_adapter": self.router.stable_id(tenant),
            "canary_id": canary_id,
            "output_path": self._artifact_path(tenant, state.version),
            "drift": {k: v for k, v in stats.items()
                      if isinstance(v, (int, float))},
        }
        try:
            run = self._submit(request)
        except Exception as exc:  # noqa: BLE001 - a failed submission
            # must not kill the loop; cooldown spaces the next attempt
            DRIFT_EVENTS.inc(adapter=tenant, event="retrain_failed")
            flight_record("tune.failed", adapter=tenant,
                          error=str(exc), at=now)
            logger.warning("continuous-tuning retrain submit failed",
                           tenant=tenant, error=str(exc))
            state.last_concluded_at = now
            self._journal_append(op="concluded", tenant=tenant, at=now)
            return
        uid = getattr(getattr(run, "metadata", None), "uid", "")
        state.inflight = {"run": run, "uid": uid, "canary_id": canary_id,
                          "output_path": request["output_path"],
                          "submitted_at": now}
        self._journal_append(op="retrain", tenant=tenant, uid=uid,
                             canary_id=canary_id,
                             output_path=request["output_path"],
                             version=state.version, at=now)
        DRIFT_EVENTS.inc(adapter=tenant, event="retrain_submitted")
        flight_record("tune.submitted", adapter=tenant, canary=canary_id,
                      uid=uid, at=now)
        out["actions"].append({"action": "retrain", "tenant": tenant,
                               "canary": canary_id, "uid": uid})

    def _default_submit(self, request: dict):
        """Submit the LoRA fine-tune as a run through the launcher
        (``run.new_function``): ``local`` runs the handler in this
        process; any other kind keeps ``run(watch=False)``, which reaches
        the remote launcher (item 14 of the port). The job receives the
        request as params and must write the adapter ``.npz`` to
        ``output_path``."""
        from ..run import new_function

        fn = new_function(
            f"tune-{request['tenant']}", kind=self.retrain_kind,
            project=self.project, image=self.retrain_image or "",
            handler=self.retrain_handler)
        if self.retrain_kind == "local":
            return fn.run(params=request, local=True)
        return fn.run(params=request, watch=False)

    def _poll_retrain(self, tenant: str, state: _TenantState,
                      now: float, out: dict):
        from ..model import RunStates
        from ..obs import DRIFT_EVENTS, flight_record
        from ..utils import logger

        run = state.inflight["run"]
        if run is None:
            # adopted from the journal after a restart: re-attach to the
            # ONE submitted run by uid — never resubmit
            run = state.inflight["run"] = _AdoptedRun(
                self.db, self.project, state.inflight["uid"])
        try:
            run_state = run.state()
        except Exception:  # noqa: BLE001 - a flaky DB read is not a
            return         # verdict; poll again next tick
        if run_state not in RunStates.terminal_states():
            return
        info, state.inflight = state.inflight, None
        if run_state != RunStates.completed:
            DRIFT_EVENTS.inc(adapter=tenant, event="retrain_failed")
            flight_record("tune.failed", adapter=tenant,
                          uid=info["uid"], state=run_state, at=now)
            state.last_concluded_at = now
            self._journal_append(op="concluded", tenant=tenant, at=now)
            return
        try:
            from ..serving.adapters import load_adapter

            load_adapter(info["output_path"])
        except Exception as exc:  # noqa: BLE001 - a run that "completed"
            # without a loadable artifact must not reach traffic
            DRIFT_EVENTS.inc(adapter=tenant, event="retrain_failed")
            flight_record("tune.failed", adapter=tenant, uid=info["uid"],
                          error=f"artifact unusable: {exc}", at=now)
            logger.warning("tuned adapter artifact unusable",
                           tenant=tenant, path=info["output_path"],
                           error=str(exc))
            state.last_concluded_at = now
            self._journal_append(op="concluded", tenant=tenant, at=now)
            return
        flight_record("tune.completed", adapter=tenant, uid=info["uid"],
                      canary=info["canary_id"], at=now)
        self._start_canary(tenant, state, info, now, out)

    # -- stage: canary serving -----------------------------------------------
    def _start_canary(self, tenant: str, state: _TenantState,
                      info: dict, now: float, out: dict):
        from ..obs import CANARY_DECISIONS, CANARY_STATE, flight_record

        canary_id = info["canary_id"]
        self.serving.add_adapter_source(canary_id, info["output_path"])
        self.router.set_split(tenant, canary_id, self.fraction)
        CANARY_STATE.set(1, adapter=tenant)
        CANARY_DECISIONS.inc(adapter=tenant, decision="start")
        state.canary = {"id": canary_id, "started": now,
                        "fraction": self.fraction,
                        "output_path": info["output_path"],
                        "evaluator": self._canary_evaluator(tenant,
                                                            canary_id),
                        "better": 0, "worse": 0}
        self._journal_append(op="canary", tenant=tenant,
                             canary_id=canary_id,
                             fraction=self.fraction,
                             output_path=info["output_path"],
                             started=now)
        flight_record("canary.start", adapter=tenant, canary=canary_id,
                      fraction=self.fraction, at=now)
        out["actions"].append({"action": "canary_start",
                               "tenant": tenant, "canary": canary_id})

    def _canary_evaluator(self, tenant: str, canary_id: str):
        from ..obs import SLO, SLOEvaluator

        stable_id = self.router.stable_id(tenant)
        slos = []
        if self.ttft_target_s > 0:
            slos.append(SLO(
                name=f"canary-ttft-{tenant}", kind="latency",
                family="mlt_llm_ttft_seconds", q=self.ttft_q,
                target=self.ttft_target_s,
                labels={"adapter": canary_id}))
        slos.append(SLO(
            name=f"canary-quality-{tenant}", kind="quality_delta",
            family="mlt_drift_stat", target=self.quality_target,
            labels={"adapter": stable_id, "stat": self.quality_stat},
            canary_labels={"adapter": canary_id,
                           "stat": self.quality_stat},
            direction=self.quality_direction))
        # burn thresholds at 1.0: "worse" means the canary consumed its
        # whole allowance in BOTH windows (the SRE multi-window pattern
        # keeps one blip from rolling back a good canary)
        return SLOEvaluator(self.store, slos,
                            fast_window=self.fast_window_s,
                            slow_window=self.slow_window_s,
                            fast_burn=1.0, slow_burn=1.0)

    # -- stage: promote / rollback -------------------------------------------
    def _evaluate_canary(self, tenant: str, state: _TenantState,
                         now: float, out: dict):
        from ..obs import flight_record

        canary = state.canary
        if now - canary["started"] < self.warmup_s:
            return
        if self.max_age_s > 0 and now - canary["started"] >= self.max_age_s:
            # the loop must always conclude: a canary whose windows
            # never carry signal (traffic dried up, series dropped)
            # would otherwise hold the tenant debounced and pin a bank
            # slot forever
            self._rollback(tenant, state, f"canary aged out after "
                           f"{self.max_age_s:.0f}s without a conclusive "
                           f"verdict", now, out)
            return
        statuses = canary["evaluator"].evaluate(now)
        worse = any(s.breaching for s in statuses)
        signal = statuses and all(
            s.burn_fast is not None and s.burn_slow is not None
            for s in statuses)
        better = bool(signal) and not worse and all(
            s.burn_fast <= self.promote_max_burn
            and s.burn_slow <= self.promote_max_burn for s in statuses)
        if worse:
            canary["worse"] += 1
            canary["better"] = 0
            verdict = "worse"
        elif better:
            canary["better"] += 1
            canary["worse"] = 0
            verdict = "better"
        else:
            canary["better"] = canary["worse"] = 0
            verdict = "hold"
        flight_record(
            "canary.decision", adapter=tenant, canary=canary["id"],
            verdict=verdict, at=now,
            burns={s["name"]: {"fast": s.burn_fast, "slow": s.burn_slow}
                   for s in statuses})
        out["evaluated"].setdefault(tenant, {})["canary"] = verdict
        if canary["worse"] >= self.rollback_ticks:
            self._rollback(tenant, state, "sustained canary-worse burn "
                           "(fast AND slow windows over budget)", now,
                           out)
        elif canary["better"] >= self.promote_ticks:
            self._promote(tenant, state, now, out)

    def _promote(self, tenant: str, state: _TenantState, now: float,
                 out: dict):
        from ..obs import CANARY_DECISIONS, CANARY_STATE, flight_record
        from ..utils import logger

        old_stable = self.router.stable_id(tenant)
        promoted = self.router.promote(tenant)
        CANARY_STATE.set(2, adapter=tenant)
        CANARY_DECISIONS.inc(adapter=tenant, decision="promote")
        # the displaced version's factors leave the working set (its
        # in-flight pins finish first); the ROOT tenant source stays —
        # it is the client-facing name's fallback lineage
        self.serving.retire_adapter(old_stable,
                                    keep_source=old_stable == tenant)
        # the promoted traffic is the new normal: drop the dead stable
        # id's monitor state AND its metric series; the promoted id
        # keeps its canary-phase baseline
        self.monitor.rebase(old_stable)
        self._retire_series(old_stable)
        state.canary = None
        state.drift_streak = 0
        state.last_concluded_at = now
        self._journal_append(op="promote", tenant=tenant,
                             canary_id=promoted, at=now)
        flight_record("canary.promote", adapter=tenant, canary=promoted,
                      displaced=old_stable, at=now)
        logger.info("canary promoted", tenant=tenant, adapter=promoted,
                    displaced=old_stable)
        out["actions"].append({"action": "promote", "tenant": tenant,
                               "canary": promoted,
                               "displaced": old_stable})

    def _rollback(self, tenant: str, state: _TenantState, reason: str,
                  now: float, out: dict):
        from ..obs import (
            CANARY_DECISIONS,
            CANARY_STATE,
            flight_record,
            get_flight_recorder,
        )
        from ..utils import logger

        canary_id = state.canary["id"]
        state.canary = None
        self.router.clear_split(tenant)
        self.serving.retire_adapter(canary_id)
        self.monitor.rebase(canary_id)
        self._retire_series(canary_id)
        CANARY_STATE.set(-1, adapter=tenant)
        CANARY_DECISIONS.inc(adapter=tenant, decision="rollback")
        self._journal_append(op="rollback", tenant=tenant,
                             canary_id=canary_id, at=now)
        flight_record("canary.rollback", adapter=tenant,
                      canary=canary_id, reason=reason, at=now)
        # the post-mortem: the ring already carries the causal chain —
        # drift confirmation, tune submission, canary start, the
        # decisions — ending in the rollback above
        artifact = get_flight_recorder().dump(
            f"canary-rollback-{tenant}",
            extra={"adapter": tenant, "canary": canary_id,
                   "reason": reason,
                   "drift": {k: v for k, v
                             in state.last_drift_stats.items()
                             if isinstance(v, (int, float))}})
        state.drift_streak = 0
        state.last_concluded_at = now
        logger.warning("canary rolled back", tenant=tenant,
                       canary=canary_id, reason=reason,
                       post_mortem=artifact)
        out["actions"].append({"action": "rollback", "tenant": tenant,
                               "canary": canary_id, "reason": reason,
                               "post_mortem": artifact})
