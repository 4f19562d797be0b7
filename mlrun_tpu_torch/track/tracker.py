"""Third-party experiment tracker base."""

from __future__ import annotations


class Tracker:
    """Hooks invoked around handler execution to import 3rd-party experiment
    state (mlflow runs, tensorboard logs, ...) into the run context."""

    @staticmethod
    def is_enabled() -> bool:
        return False

    def pre_run(self, context):
        """Called before the user handler runs."""

    def post_run(self, context):
        """Called after the user handler completed; import logged objects."""
