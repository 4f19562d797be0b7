"""MLflow tracker: when the user's handler logs to mlflow, its params
and metrics come into the run context after the handler returns."""

from __future__ import annotations

import os

from ..tracker import Tracker


class MLFlowTracker(Tracker):
    @staticmethod
    def is_enabled() -> bool:
        try:
            import mlflow  # noqa: F401

            return True
        except ImportError:
            return False

    def pre_run(self, context):
        import mlflow

        # route mlflow tracking into the run's artifact dir
        uri = os.path.join(context.artifact_path or ".", "mlflow")
        try:
            mlflow.set_tracking_uri(f"file://{os.path.abspath(uri)}")
        except Exception:  # noqa: BLE001
            pass
        self._run_id_before = None
        active = mlflow.active_run()
        if active:
            self._run_id_before = active.info.run_id

    def post_run(self, context):
        import mlflow

        client = mlflow.tracking.MlflowClient()
        run = mlflow.last_active_run()
        if run is None:
            return
        data = run.data
        for key, value in (data.params or {}).items():
            context.parameters.setdefault(key, value)
        for key, value in (data.metrics or {}).items():
            context.log_result(key, value)
