"""Third-party experiment trackers around a handler's run — the port's
copy of ``mlrun_tpu/track``: ``tracker_manager.pre_run`` / ``post_run``
wrap every local handler call (runtimes/local.py); the MLflow tracker
loads only where ``mlflow`` imports."""

from .tracker import Tracker  # noqa: F401
from .tracker_manager import TrackerManager, tracker_manager  # noqa: F401
