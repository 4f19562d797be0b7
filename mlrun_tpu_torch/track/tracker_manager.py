"""The process-wide tracker manager: the registered trackers plus the
default ones that import (MLflow), each failure logged, never raised."""

from __future__ import annotations

from ..utils import logger
from .tracker import Tracker


class TrackerManager:
    def __init__(self):
        self._trackers: list[Tracker] = []
        self._loaded = False

    def register(self, tracker: Tracker):
        self._trackers.append(tracker)

    def _load_default_trackers(self):
        if self._loaded:
            return
        self._loaded = True
        try:
            from .trackers.mlflow_tracker import MLFlowTracker

            if MLFlowTracker.is_enabled():
                self._trackers.append(MLFlowTracker())
        except ImportError:
            pass

    def pre_run(self, context):
        self._load_default_trackers()
        for tracker in self._trackers:
            try:
                tracker.pre_run(context)
            except Exception as exc:  # noqa: BLE001 - never fails a run
                logger.warning("tracker pre_run failed", error=str(exc))

    def post_run(self, context):
        for tracker in self._trackers:
            try:
                tracker.post_run(context)
            except Exception as exc:  # noqa: BLE001
                logger.warning("tracker post_run failed", error=str(exc))


tracker_manager = TrackerManager()
