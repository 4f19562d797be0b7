"""Run states, runtime kinds and the JobSet condition mapping — the
port's copy of ``mlrun_tpu/common/runtimes_constants.py`` (same strings,
so a run or function dict either package writes reads the same in the
other).
"""

from __future__ import annotations

# checkpoint-resume env contract for resubmitted runs: a resubmitted
# resource carries these and training/checkpoint.py resume_directive reads
# them — one definition so the two sides cannot drift
RESUME_CHECKPOINT_ENV = "MLT_RESUME_FROM_CHECKPOINT"
RESUME_STEP_ENV = "MLT_RESUME_STEP"
# the persistent kernel-build cache dir a resubmitted resource restarts
# warm from (config.COMPILE_CACHE_ENV, the reference's env name)
from ..config import COMPILE_CACHE_ENV  # noqa: E402,F401


class RunStates:
    created = "created"
    pending = "pending"
    running = "running"
    completed = "completed"
    error = "error"
    aborting = "aborting"
    aborted = "aborted"
    skipped = "skipped"
    unknown = "unknown"

    @staticmethod
    def all() -> list[str]:
        return [
            RunStates.created, RunStates.pending, RunStates.running,
            RunStates.completed, RunStates.error, RunStates.aborting,
            RunStates.aborted, RunStates.skipped, RunStates.unknown,
        ]

    @staticmethod
    def terminal_states() -> list[str]:
        return [RunStates.completed, RunStates.error, RunStates.aborted,
                RunStates.skipped]

    @staticmethod
    def error_states() -> list[str]:
        return [RunStates.error, RunStates.aborted]

    @staticmethod
    def abortable_states() -> list[str]:
        return [RunStates.created, RunStates.pending, RunStates.running,
                RunStates.unknown]


class RuntimeKinds:
    local = "local"
    handler = "handler"
    job = "job"
    tpujob = "tpujob"
    dask = "dask"
    spark = "spark"
    databricks = "databricks"
    serving = "serving"
    remote = "remote"  # generic http-triggered function
    application = "application"

    @staticmethod
    def all() -> list[str]:
        return [
            RuntimeKinds.local, RuntimeKinds.handler, RuntimeKinds.job,
            RuntimeKinds.tpujob, RuntimeKinds.dask, RuntimeKinds.spark,
            RuntimeKinds.databricks, RuntimeKinds.serving,
            RuntimeKinds.remote, RuntimeKinds.application,
        ]

    @staticmethod
    def handled_kinds() -> list[str]:
        """Kinds with a server-side runtime handler (resource recovery)."""
        return [RuntimeKinds.job, RuntimeKinds.tpujob, RuntimeKinds.dask,
                RuntimeKinds.spark]

    @staticmethod
    def remote_kinds() -> list[str]:
        return [RuntimeKinds.job, RuntimeKinds.tpujob, RuntimeKinds.dask,
                RuntimeKinds.spark, RuntimeKinds.serving,
                RuntimeKinds.remote, RuntimeKinds.application]

    @staticmethod
    def pod_creating_kinds() -> list[str]:
        return [RuntimeKinds.job, RuntimeKinds.tpujob, RuntimeKinds.dask]


class PodPhases:
    pending = "Pending"
    running = "Running"
    succeeded = "Succeeded"
    failed = "Failed"
    unknown = "Unknown"

    @staticmethod
    def to_run_state(phase: str) -> str:
        return {
            PodPhases.pending: RunStates.pending,
            PodPhases.running: RunStates.running,
            PodPhases.succeeded: RunStates.completed,
            PodPhases.failed: RunStates.error,
        }.get(phase, RunStates.unknown)


class JobSetConditions:
    """JobSet condition types a tpujob run's state follows."""

    startup_policy_completed = "StartupPolicyCompleted"
    completed = "Completed"
    failed = "Failed"
    suspended = "Suspended"

    @staticmethod
    def to_run_state(conditions: list[dict]) -> str:
        by_type = {
            c.get("type"): c for c in conditions or []
            if c.get("status") in (True, "True")
        }
        if JobSetConditions.completed in by_type:
            return RunStates.completed
        if JobSetConditions.failed in by_type:
            return RunStates.error
        if JobSetConditions.suspended in by_type:
            return RunStates.pending
        return RunStates.running


class ThresholdStates:
    pending_scheduled = "pending_scheduled"
    pending_not_scheduled = "pending_not_scheduled"
    image_pull_backoff = "image_pull_backoff"
    executing = "executing"
