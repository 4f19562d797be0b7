"""Time-series store for model-endpoint metrics — the port's copy of
``mlrun_tpu/model_monitoring/tsdb.py``: an embedded SQLite (WAL) series
table (the reference's schema, so a file either package writes reads the
same in the other), giving every deployment a queryable metric history
with zero extra infrastructure.

Written by ``ModelMonitoringWriter`` on each application window; read
through :meth:`MetricsTSDB.query` (the service's time-range endpoints
are item 14's).
"""

from __future__ import annotations

import os
import sqlite3
import threading
import time
from typing import Optional

_SCHEMA = """
CREATE TABLE IF NOT EXISTS endpoint_metrics (
    project TEXT NOT NULL, endpoint TEXT NOT NULL, metric TEXT NOT NULL,
    ts REAL NOT NULL, value REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_endpoint_metrics
    ON endpoint_metrics (project, endpoint, metric, ts);
CREATE INDEX IF NOT EXISTS idx_endpoint_metrics_ts
    ON endpoint_metrics (ts);
"""


class MetricsTSDB:
    """Append-only metric series keyed by (project, endpoint, metric)."""

    def __init__(self, path: str = ""):
        if not path:
            path = _default_path()
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self.path = path
        self._lock = threading.Lock()
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.executescript(_SCHEMA)

    def write(self, project: str, endpoint: str, metrics: dict,
              ts: Optional[float] = None):
        """Record one sample per metric name at ``ts`` (now by default)."""
        ts = time.time() if ts is None else ts
        rows = [(project, endpoint, name, ts, float(value))
                for name, value in metrics.items()
                if isinstance(value, (int, float))]
        if not rows:
            return
        with self._lock:
            self._conn.executemany(
                "INSERT INTO endpoint_metrics VALUES (?,?,?,?,?)", rows)
            self._conn.commit()

    def query(self, project: str, endpoint: str, metric: str = "",
              start: float = 0.0, end: Optional[float] = None,
              max_points: int = 1000) -> list[dict]:
        """Series points (ts ascending), optionally downsampled by simple
        stride selection to ``max_points``."""
        end = time.time() if end is None else end
        sql = ("SELECT metric, ts, value FROM endpoint_metrics "
               "WHERE project=? AND endpoint=? AND ts>=? AND ts<=?")
        params: list = [project, endpoint, start, end]
        if metric:
            sql += " AND metric=?"
            params.append(metric)
        sql += " ORDER BY ts"
        with self._lock:
            rows = self._conn.execute(sql, params).fetchall()
        series: dict[str, list] = {}
        for name, ts, value in rows:
            series.setdefault(name, []).append((ts, value))
        out = []
        max_points = max(1, int(max_points))
        for name, points in series.items():
            stride = max(1, -(-len(points) // max_points))  # ceil div
            # stride from the END so the newest sample always survives
            # downsampling (dashboards care about the latest value most)
            kept = points[::-stride][::-1]
            out.append({"metric": name,
                        "points": [{"ts": ts, "value": value}
                                   for ts, value in kept]})
        return out

    def list_metrics(self, project: str, endpoint: str) -> list[str]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT DISTINCT metric FROM endpoint_metrics "
                "WHERE project=? AND endpoint=?",
                (project, endpoint)).fetchall()
        return sorted(r[0] for r in rows)

    def prune(self, older_than_s: float):
        """Drop samples older than ``now - older_than_s`` (retention)."""
        cutoff = time.time() - older_than_s
        with self._lock:
            self._conn.execute(
                "DELETE FROM endpoint_metrics WHERE ts<?", (cutoff,))
            self._conn.commit()

    def close(self):
        with self._lock:
            self._conn.close()


_default: Optional[MetricsTSDB] = None
_default_lock = threading.Lock()


def _default_path() -> str:
    from ..config import home_dir

    return os.path.join(home_dir(), "monitoring", "metrics.db")


def get_metrics_tsdb() -> MetricsTSDB:
    """Process-wide default store, re-resolved if MLT_HOME moves (tests)."""
    global _default
    path = _default_path()
    with _default_lock:
        if _default is None or _default.path != path:
            # do NOT close the retired instance: other threads may still
            # hold it (service handlers vs controller); sqlite connections
            # close on GC once the last caller drops its reference
            _default = MetricsTSDB(path)
        return _default
