"""Monitoring application SDK — the port's copy of ``mlrun_tpu/
model_monitoring/applications.py``: the window context handed to
applications, their result record, and the data-drift and latency
applications. The frames are pandas objects, but this module imports no
pandas: the controller builds them (``controller.run_once``)."""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Optional

import numpy as np

from .metrics import drift_per_feature

if TYPE_CHECKING:
    import pandas as pd


@dataclasses.dataclass
class MonitoringContext:
    """Window of inference data handed to applications."""

    project: str
    endpoint_id: str
    model_name: str
    sample_df: pd.DataFrame          # window of inputs
    reference_df: Optional[pd.DataFrame]  # training-set sample
    start: str
    end: str
    latencies_microsec: list = dataclasses.field(default_factory=list)
    error_count: int = 0
    # per-feature StreamingHistogram sketches (metrics.py) — present when
    # the stream processor folded the window into fixed-memory histograms;
    # lets drift run on windows too large to hold as a dataframe
    sample_histograms: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class ApplicationResult:
    name: str
    value: float
    kind: str = "metric"             # metric | drift | anomaly
    status: str = "no_detection"     # no_detection | potential | detected
    extra: dict = dataclasses.field(default_factory=dict)


class ModelMonitoringApplicationBase:
    """Subclass and implement do_tracking(ctx) -> list[ApplicationResult]."""

    name = "app"

    def do_tracking(self, ctx: MonitoringContext) -> list[ApplicationResult]:
        raise NotImplementedError


class HistogramDataDriftApplication(ModelMonitoringApplicationBase):
    """TVD/Hellinger/KL drift vs the reference sample
    (reference applications/histogram_data_drift.py)."""

    name = "histogram-data-drift"

    def __init__(self, potential_threshold: float = 0.5,
                 detected_threshold: float = 0.7, bins: int = 20):
        self.potential = potential_threshold
        self.detected = detected_threshold
        self.bins = bins

    def do_tracking(self, ctx: MonitoringContext) -> list[ApplicationResult]:
        if ctx.reference_df is None:
            return []
        if not ctx.sample_df.empty:
            per_feature = drift_per_feature(ctx.sample_df, ctx.reference_df,
                                            self.bins)
        elif ctx.sample_histograms:
            # window too large to materialize (or already folded): compute
            # drift from the streamed sketches against the reference
            from .metrics import drift_between_histograms

            per_feature = {}
            for name, hist in ctx.sample_histograms.items():
                if name not in ctx.reference_df.columns:
                    continue
                try:
                    metrics = drift_between_histograms(
                        hist, ctx.reference_df[name])
                except (TypeError, ValueError):
                    continue  # non-numeric reference column — skip, like
                    # the dataframe path does
                if metrics is not None:
                    per_feature[name] = metrics
        else:
            return []
        if not per_feature:
            return []
        # headline score: mean of (tvd + hellinger)/2 across features
        # (the reference's general drift formula)
        scores = [(m["tvd"] + m["hellinger"]) / 2
                  for m in per_feature.values()]
        score = float(np.mean(scores))
        status = "no_detection"
        if score >= self.detected:
            status = "detected"
        elif score >= self.potential:
            status = "potential"
        return [
            ApplicationResult("data_drift_score", score, kind="drift",
                              status=status,
                              extra={"per_feature": per_feature}),
            ApplicationResult(
                "kld_mean",
                float(np.mean([m["kld"] for m in per_feature.values()]))),
        ]


class LatencyApplication(ModelMonitoringApplicationBase):
    """Latency SLO application (tracks TTFT-style
    latency percentiles per window)."""

    name = "latency"

    def __init__(self, p95_threshold_microsec: float = 200_000.0):
        self.threshold = p95_threshold_microsec

    def do_tracking(self, ctx: MonitoringContext) -> list[ApplicationResult]:
        if not ctx.latencies_microsec:
            return []
        lat = np.asarray(ctx.latencies_microsec, dtype=np.float64)
        p50, p95 = float(np.percentile(lat, 50)), float(np.percentile(lat, 95))
        status = "detected" if p95 > self.threshold else "no_detection"
        return [
            ApplicationResult("latency_p50_microsec", p50),
            ApplicationResult("latency_p95_microsec", p95, kind="anomaly",
                              status=status),
        ]
