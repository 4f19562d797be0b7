"""Drift metrics — the port's copy of ``mlrun_tpu/model_monitoring/
metrics.py``: TVD / Hellinger / KL / PSI over histograms, the bounded
``FixedHistogram`` and the range-locking ``StreamingHistogram`` sketches.
numpy only; the frame-taking ``drift_per_feature`` reads its columns by
name and needs no pandas import of its own."""

from __future__ import annotations

import numpy as np

EPS = 1e-10


def _normalize(hist: np.ndarray) -> np.ndarray:
    hist = np.asarray(hist, dtype=np.float64)
    total = hist.sum()
    if total <= 0:
        return np.full_like(hist, 1.0 / max(len(hist), 1))
    return hist / total


def total_variance_distance(p, q) -> float:
    p, q = _normalize(p), _normalize(q)
    return float(0.5 * np.abs(p - q).sum())


def hellinger_distance(p, q) -> float:
    p, q = _normalize(p), _normalize(q)
    return float(np.sqrt(max(0.0, 1.0 - np.sum(np.sqrt(p * q)))))


def kl_divergence(p, q, symmetric: bool = True) -> float:
    p, q = _normalize(p) + EPS, _normalize(q) + EPS
    kl_pq = float(np.sum(p * np.log(p / q)))
    if not symmetric:
        return kl_pq
    kl_qp = float(np.sum(q * np.log(q / p)))
    return kl_pq + kl_qp


def psi(actual, expected, eps: float = 1e-4) -> float:
    """Population stability index between two histograms: ``Σ (a_i -
    e_i) · ln(a_i / e_i)`` over normalized bins, epsilon-smoothed so an
    empty bin contributes a large-but-finite term. Always >= 0; the
    classic interpretation bands are < 0.1 stable, 0.1-0.2 moderate
    shift, >= 0.2 significant shift (the default drift threshold in
    ``config.MODEL_MONITORING_DEFAULTS``' continuous drift block)."""
    a = _normalize(actual) + eps
    e = _normalize(expected) + eps
    a, e = a / a.sum(), e / e.sum()
    return float(np.sum((a - e) * np.log(a / e)))


class FixedHistogram:
    """Bounded histogram over a FIXED ``[lo, hi)`` range — the
    serving-side token/length/latency sketch behind the drift monitor
    (stream_processing.AdapterTrafficMonitor): O(bins) state at any
    traffic volume, out-of-range values clip into the edge bins, and two
    windows over the same shape compare directly (PSI/KL share support
    by construction). Unlike :class:`StreamingHistogram` there is no
    warmup/range-lock phase: the range is known up front (token ids in
    [0, vocab), output lengths in [0, max_new], ...)."""

    __slots__ = ("lo", "hi", "bins", "counts", "total")

    def __init__(self, lo: float, hi: float, bins: int = 32):
        if not hi > lo:
            raise ValueError(f"need hi > lo, got [{lo}, {hi})")
        if bins <= 0:
            raise ValueError(f"bins must be > 0, got {bins}")
        self.lo = float(lo)
        self.hi = float(hi)
        self.bins = int(bins)
        self.counts = np.zeros(self.bins, dtype=np.int64)
        self.total = 0

    def update(self, values) -> None:
        values = np.asarray(values, dtype=np.float64).ravel()
        values = values[np.isfinite(values)]
        if values.size == 0:
            return
        scaled = (values - self.lo) / (self.hi - self.lo) * self.bins
        idx = np.clip(scaled.astype(np.int64), 0, self.bins - 1)
        np.add.at(self.counts, idx, 1)
        self.total += int(values.size)

    def merge(self, other: "FixedHistogram") -> None:
        if (other.lo, other.hi, other.bins) != (self.lo, self.hi,
                                                self.bins):
            raise ValueError("cannot merge FixedHistograms of different "
                             "shape")
        self.counts += other.counts
        self.total += other.total

    def snapshot(self) -> np.ndarray:
        return self.counts.copy()

    def reset(self) -> None:
        self.counts[:] = 0
        self.total = 0


def histogram(values, bins: int = 20, range_=None) -> tuple[np.ndarray, np.ndarray]:
    values = np.asarray(values, dtype=np.float64)
    values = values[np.isfinite(values)]
    if values.size == 0:
        return np.zeros(bins), np.linspace(0, 1, bins + 1)
    counts, edges = np.histogram(values, bins=bins, range=range_)
    return counts, edges


def drift_per_feature(sample_df, reference_df, bins: int = 20) -> dict:
    """Compute TVD/Hellinger/KL per shared numeric feature."""
    out: dict[str, dict] = {}
    for column in reference_df.columns:
        if column not in sample_df.columns:
            continue
        try:
            ref_values = np.asarray(reference_df[column], dtype=np.float64)
        except (TypeError, ValueError):
            continue  # non-numeric column (label/categorical) — skip
        ref_values = ref_values[np.isfinite(ref_values)]
        if ref_values.size == 0:
            continue
        lo, hi = float(ref_values.min()), float(ref_values.max())
        if lo == hi:
            hi = lo + 1.0
        ref_hist, _ = histogram(ref_values, bins, (lo, hi))
        try:
            cur_hist, _ = histogram(sample_df[column], bins, (lo, hi))
        except (TypeError, ValueError):
            continue
        out[column] = {
            "tvd": total_variance_distance(ref_hist, cur_hist),
            "hellinger": hellinger_distance(ref_hist, cur_hist),
            "kld": kl_divergence(ref_hist, cur_hist),
        }
    return out


class StreamingHistogram:
    """Fixed-memory histogram sketch for high-cardinality / unbounded
    feature streams: O(bins) state regardless of how many events flow
    through, so drift can be computed without buffering raw windows.

    The bin range locks after ``warmup`` values (from a buffered prefix);
    later out-of-range values clip into the edge bins. Serializes to a
    plain dict for persistence next to the monitoring parquet.
    (Reference keeps full raw windows — mlrun/model_monitoring/
    stream_processing.py aggregates into storey windows instead.)
    """

    def __init__(self, bins: int = 20, warmup: int = 1000):
        self.bins = bins
        self.warmup = warmup
        self.edges: np.ndarray | None = None
        self.counts = np.zeros(bins, dtype=np.int64)
        self.total = 0
        self._buffer: list = []

    def update(self, values) -> None:
        values = np.asarray(values, dtype=np.float64).ravel()
        values = values[np.isfinite(values)]
        if values.size == 0:
            return
        if self.edges is None:
            self._buffer.extend(values.tolist())
            if len(self._buffer) >= self.warmup:
                self._lock_range()
            return
        self._add(values)

    def _lock_range(self):
        buffered = np.asarray(self._buffer, dtype=np.float64)
        lo, hi = float(buffered.min()), float(buffered.max())
        if lo == hi:
            hi = lo + 1.0
        self.edges = np.linspace(lo, hi, self.bins + 1)
        self._buffer = []
        self._add(buffered)

    def _add(self, values: np.ndarray):
        clipped = np.clip(values, self.edges[0], self.edges[-1])
        idx = np.minimum(
            np.searchsorted(self.edges, clipped, side="right") - 1,
            self.bins - 1)
        idx = np.maximum(idx, 0)
        np.add.at(self.counts, idx, 1)
        self.total += values.size

    def finalize(self) -> None:
        """Lock the range from whatever has been buffered (end of window)."""
        if self.edges is None and self._buffer:
            self._lock_range()

    def to_dict(self) -> dict:
        """Serialize WITHOUT finalizing: a still-buffering sketch keeps its
        buffer, so persistence between small batches cannot prematurely
        lock the bin range to the first batch's min/max."""
        return {
            "bins": self.bins,
            "warmup": self.warmup,
            "edges": list(self.edges) if self.edges is not None else None,
            "counts": self.counts.tolist(),
            "total": self.total,
            "buffer": list(self._buffer),
        }

    @classmethod
    def from_dict(cls, data: dict) -> "StreamingHistogram":
        hist = cls(bins=data["bins"], warmup=data.get("warmup", 1000))
        if data.get("edges") is not None:
            hist.edges = np.asarray(data["edges"], dtype=np.float64)
        hist.counts = np.asarray(data["counts"], dtype=np.int64)
        hist.total = int(data.get("total", 0))
        hist._buffer = list(data.get("buffer", []))
        return hist


def drift_between_histograms(current: "StreamingHistogram",
                             reference_values) -> dict | None:
    """TVD/Hellinger/KL between a streamed sketch and raw reference
    values binned on the SKETCH's edges (so both distributions share
    support)."""
    current.finalize()
    if current.edges is None or current.total == 0:
        return None
    ref = np.asarray(reference_values, dtype=np.float64).ravel()
    ref = ref[np.isfinite(ref)]
    if ref.size == 0:
        return None
    ref = np.clip(ref, current.edges[0], current.edges[-1])
    ref_counts, _ = np.histogram(ref, bins=current.edges)
    return {
        "tvd": total_variance_distance(ref_counts, current.counts),
        "hellinger": hellinger_distance(ref_counts, current.counts),
        "kld": kl_divergence(ref_counts, current.counts),
    }
