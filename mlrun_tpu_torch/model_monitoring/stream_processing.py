"""Monitoring event-stream processing — the port's copy of
``mlrun_tpu/model_monitoring/stream_processing.py``.

The stream is the project's in-memory stream the serving graph pushes
to when it tracks models (``serving/v2_serving._ModelLogPusher``); the
processor drains it, aggregates per-endpoint statistics windows, writes
parquet (pandas and pyarrow are imported inside ``run_once`` only), and
updates model-endpoint records in the run DB.

``AdapterTrafficMonitor`` is the serving-side half of the
continuous-tuning loop: per-adapter drift over the engines' sample tap,
numpy only.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict, deque
from typing import Optional

from ..chaos import FaultPoints, fire
from ..config import MODEL_MONITORING_DEFAULTS, home_dir
from ..utils import logger
from ..utils.helpers import now_iso


def get_monitoring_stream(project: str):
    """The stream serving events are pushed to for a project: the
    reference's default ``inmem`` kind (its ``file`` kind is misread by
    ``EventStreamProcessor._pull`` in both packages, so it is not ported)."""
    from ..serving.streams import get_stream_pusher

    return get_stream_pusher(f"memory://monitoring-{project}")


def get_monitoring_parquet_dir(project: str) -> str:
    return os.path.join(home_dir(), "monitoring", project, "parquet")


class EventStreamProcessor:
    """Drain monitoring events → per-endpoint windowed stats + parquet."""

    def __init__(self, project: str, db=None):
        self.project = project
        self.stream = get_monitoring_stream(project)
        if db is None:
            from ..db import get_run_db

            db = get_run_db()
        self.db = db
        self._histograms: dict[str, dict] = {}

    def _pull(self, max_items: int = 10000) -> list[dict]:
        return self.stream.pull(max_items)

    def run_once(self) -> int:
        """Process pending events; returns the number processed."""
        import pandas as pd

        events = self._pull()
        if not events:
            return 0
        by_endpoint: dict[str, list[dict]] = defaultdict(list)
        for event in events:
            endpoint_id = self._endpoint_id(event)
            by_endpoint[endpoint_id].append(event)

        parquet_dir = get_monitoring_parquet_dir(self.project)
        os.makedirs(parquet_dir, exist_ok=True)
        for endpoint_id, endpoint_events in by_endpoint.items():
            rows = []
            latencies = []
            errors = 0
            for event in endpoint_events:
                if event.get("error"):
                    errors += 1
                    continue
                latencies.append(event.get("microsec", 0))
                inputs = event.get("request", {}).get("inputs")
                outputs = event.get("resp", {}).get("outputs")
                rows.append({
                    "when": event.get("when"),
                    "model": event.get("model"),
                    "inputs": json.dumps(inputs, default=str),
                    "outputs": json.dumps(outputs, default=str),
                    "microsec": event.get("microsec", 0),
                })
            if rows:
                df = pd.DataFrame(rows)
                path = os.path.join(parquet_dir, f"{endpoint_id}.parquet")
                if os.path.isfile(path):
                    df = pd.concat([pd.read_parquet(path), df],
                                   ignore_index=True)
                df.to_parquet(path, index=False)
                self._update_histograms(endpoint_id, rows)
            self._update_endpoint(endpoint_id, endpoint_events, latencies,
                                  errors)
        return len(events)

    # -- streaming feature histograms ---------------------------------------
    def load_histograms(self, endpoint_id: str) -> dict:
        """Per-feature StreamingHistogram sketches folded since the last
        reset (i.e. the CURRENT analysis window's data, when the
        controller resets after each window)."""
        return self._histograms.get(endpoint_id, {})

    def reset_histograms(self, endpoint_id: str):
        """Drop the endpoint's sketches — called by the controller after a
        window is analyzed so the next window starts fresh (a lifetime
        accumulation would mask drift in exactly the high-volume windows
        the sketches exist for)."""
        self._histograms.pop(endpoint_id, None)

    def _update_histograms(self, endpoint_id: str, rows: list[dict]):
        """Fold this batch's numeric input features into fixed-memory
        histogram sketches (metrics.StreamingHistogram) — drift for
        high-cardinality/unbounded streams runs from these instead of the
        raw window. Sketches are in-memory per processor: they describe
        the window between controller resets, not the endpoint lifetime."""
        from .metrics import StreamingHistogram

        feature_values: dict[str, list] = defaultdict(list)
        for row in rows:
            try:
                batch = json.loads(row.get("inputs") or "null")
            except (TypeError, ValueError):
                continue
            if not isinstance(batch, list):
                continue
            for item in batch:
                if isinstance(item, dict):
                    named = item.items()
                elif isinstance(item, list):
                    named = ((f"f{i}", v) for i, v in enumerate(item))
                else:
                    named = (("f0", item),)
                for name, value in named:
                    if isinstance(value, (int, float)) and not isinstance(
                            value, bool):
                        feature_values[name].append(float(value))
        if not feature_values:
            return
        hists = self._histograms.setdefault(endpoint_id, {})
        for name, values in feature_values.items():
            hist = hists.get(name)
            if hist is None:
                hist = hists[name] = StreamingHistogram()
            hist.update(values)

    @staticmethod
    def _endpoint_id(event: dict) -> str:
        fn = event.get("function_uri", "").replace("/", "-") or "unknown"
        return f"{fn}.{event.get('model', 'model')}"

    def _update_endpoint(self, endpoint_id: str, events: list, latencies: list,
                         errors: int):
        try:
            try:
                record = self.db.get_model_endpoint(self.project, endpoint_id)
            except Exception:  # noqa: BLE001 - create on first event
                first = events[0]
                record = {
                    "uid": endpoint_id,
                    "project": self.project,
                    "name": first.get("model", ""),
                    "function_uri": first.get("function_uri", ""),
                    "model_class": first.get("class", ""),
                    "state": "ready",
                    "first_request": first.get("when"),
                    "metrics": {},
                    "error_count": 0,
                }
            metrics = record.setdefault("metrics", {})
            count = metrics.get("requests", 0) + len(latencies)
            metrics["requests"] = count
            if latencies:
                prev_avg = metrics.get("avg_latency_microsec", 0)
                prev_n = count - len(latencies)
                metrics["avg_latency_microsec"] = (
                    (prev_avg * prev_n + sum(latencies)) / max(count, 1))
                metrics["max_latency_microsec"] = max(
                    metrics.get("max_latency_microsec", 0), max(latencies))
            record["error_count"] = record.get("error_count", 0) + errors
            record["last_request"] = events[-1].get("when", now_iso())
            self.db.store_model_endpoint(self.project, endpoint_id, record)
        except Exception as exc:  # noqa: BLE001 - monitoring is best-effort
            logger.warning("failed to update model endpoint",
                           endpoint=endpoint_id, error=str(exc))


# -- serving-side per-adapter traffic analysis (docs/continuous_tuning.md) ---
class _AdapterTraffic:
    """One adapter's monitoring state: a locked reference distribution
    (the first ``reference_min`` samples after (re)baselining) plus the
    current analysis window, all in fixed-memory sketches."""

    __slots__ = ("ref_tokens", "ref_lengths", "cur_tokens", "cur_lengths",
                 "ref_count", "locked", "quality", "ttft", "seen")

    def __init__(self, monitor: "AdapterTrafficMonitor"):
        from .metrics import FixedHistogram

        shape = (0.0, float(monitor.vocab_size), monitor.token_bins)
        len_shape = (0.0, float(monitor.max_output_len),
                     monitor.length_bins)
        self.ref_tokens = FixedHistogram(*shape)
        self.ref_lengths = FixedHistogram(*len_shape)
        self.cur_tokens = FixedHistogram(*shape)
        self.cur_lengths = FixedHistogram(*len_shape)
        self.ref_count = 0
        self.locked = False
        # rolling per-sample stats (bounded; survive window resets so a
        # low-traffic canary still yields quality/latency points)
        self.quality: deque = deque(maxlen=256)
        self.ttft: deque = deque(maxlen=256)
        self.seen = 0


class AdapterTrafficMonitor:
    """Per-adapter windowed token/logit/output statistics from
    serving-side samples (``serving/samples.py``) — the drift half of
    the continuous fine-tune→canary→promote loop. It needs no pandas.

    Each adapter's first ``reference_min`` samples lock a reference
    distribution (output token ids + output lengths in bounded
    ``FixedHistogram`` sketches). After that, samples accumulate into
    the current window; once it holds ``window_min`` samples,
    :meth:`evaluate` yields a drift verdict — PSI (and symmetric KL)
    between window and reference, drifted when PSI crosses
    ``psi_threshold`` — and resets the window. Smaller windows yield
    ``drifted=None`` ("no signal"), never "no drift".

    Rolling per-sample stats (first-token logit margin as
    ``quality_mean``, TTFT mean) ride every evaluation so the canary
    evaluator's ``quality_delta`` objective has per-adapter series even
    at canary traffic volumes.

    Every evaluation fires the ``monitor.drift`` chaos point with a
    mutable ``box`` — a test's ``action()`` can overwrite
    ``box["stats"]`` / ``box["drifted"]`` for deterministic drift
    injection with zero wall-clock coupling. Deterministic by
    construction: no internal clock reads; ``now`` is the caller's.
    """

    def __init__(self, vocab_size: int = 32768,
                 token_bins: int | None = None,
                 length_bins: int | None = None,
                 max_output_len: int = 512,
                 reference_min: int | None = None,
                 window_min: int | None = None,
                 psi_threshold: float | None = None,
                 max_adapters: int | None = None):
        conf = MODEL_MONITORING_DEFAULTS["continuous"]["drift"]

        def knob(value, name, cast):
            return cast(conf[name]) if value is None else cast(value)

        self.vocab_size = int(vocab_size)
        self.token_bins = knob(token_bins, "token_bins", int)
        self.length_bins = knob(length_bins, "length_bins", int)
        self.max_output_len = int(max_output_len)
        self.reference_min = knob(reference_min, "reference_min", int)
        self.window_min = knob(window_min, "window_min", int)
        self.psi_threshold = knob(psi_threshold, "psi_threshold", float)
        self.max_adapters = knob(max_adapters, "max_adapters", int)
        self._state: dict[str, _AdapterTraffic] = {}
        self.dropped_adapters = 0   # samples past the adapter cap

    # -- ingestion -----------------------------------------------------------
    def adapters(self) -> list:
        return sorted(self._state)

    def observe(self, sample: dict) -> None:
        """Fold one completed-request sample (see
        ``serving/samples.emit_sample`` for the schema)."""
        adapter = sample.get("adapter", "") or ""
        state = self._state.get(adapter)
        if state is None:
            if len(self._state) >= self.max_adapters:
                self.dropped_adapters += 1
                return
            state = self._state[adapter] = _AdapterTraffic(self)
        state.seen += 1
        tokens = sample.get("tokens") or []
        generated = sample.get("generated", len(tokens))
        if not state.locked:
            state.ref_tokens.update(tokens)
            state.ref_lengths.update([generated])
            state.ref_count += 1
            if state.ref_count >= self.reference_min:
                state.locked = True
        else:
            state.cur_tokens.update(tokens)
            state.cur_lengths.update([generated])
        margin = sample.get("logit_margin")
        if margin is not None and margin == margin:  # finite, non-NaN
            state.quality.append(float(margin))
        ttft = sample.get("ttft_s")
        if ttft is not None:
            state.ttft.append(float(ttft))

    # -- evaluation ----------------------------------------------------------
    def evaluate(self, adapter: str, now: float) -> tuple[dict, object]:
        """One drift evaluation for ``adapter`` at ``now`` → ``(stats,
        drifted)`` where ``drifted`` is True/False on a full window and
        None while the window (or the reference) is still filling. A
        True/False verdict consumes the window (the next one starts
        fresh); rolling quality/latency stats are always present when
        any sample carried them."""
        from .metrics import kl_divergence, psi

        state = self._state.get(adapter)
        if state is None:
            stats = {"sample_count": 0.0}
            return self._fire(adapter, stats, None, now)
        stats = {
            # one per SAMPLE (the lengths sketch takes one value per
            # request; the tokens sketch counts one per token id)
            "sample_count": float(state.cur_lengths.total
                                  if state.locked else 0),
            "reference_count": float(state.ref_count),
        }
        if state.quality:
            stats["quality_mean"] = sum(state.quality) / len(state.quality)
        if state.ttft:
            stats["ttft_mean_s"] = sum(state.ttft) / len(state.ttft)
        drifted = None
        if state.locked and state.cur_lengths.total >= self.window_min:
            stats["token_psi"] = psi(state.cur_tokens.snapshot(),
                                     state.ref_tokens.snapshot())
            stats["token_kld"] = kl_divergence(
                state.cur_tokens.snapshot(), state.ref_tokens.snapshot())
            stats["length_psi"] = psi(state.cur_lengths.snapshot(),
                                      state.ref_lengths.snapshot())
            drifted = (stats["token_psi"] >= self.psi_threshold
                       or stats["length_psi"] >= self.psi_threshold)
            state.cur_tokens.reset()
            state.cur_lengths.reset()
        return self._fire(adapter, stats, drifted, now)

    @staticmethod
    def _fire(adapter: str, stats: dict, drifted, now: float):
        box = {"adapter": adapter, "stats": stats, "drifted": drifted}
        fire(FaultPoints.monitor_drift, box=box, adapter=adapter, now=now)
        return box["stats"], box["drifted"]

    def rebase(self, adapter: str) -> None:
        """Drop the adapter's reference AND window so the NEXT
        ``reference_min`` samples lock a fresh baseline — called after a
        promotion (the drifted traffic is the new normal; keeping the
        old reference would re-trigger a retrain forever)."""
        self._state.pop(adapter, None)
