"""The run-side execution context — the port's copy of
``mlrun_tpu/execution.py``.

``MLClientCtx`` is the object handed to a run's handler: parameters,
inputs, secrets, result / artifact / model logging into the run db, state
transitions and heartbeats. Which process of a multi-process run logs is
:func:`is_logging_worker`: torchrun's ``RANK``, then ``MLT_WORKER_RANK``,
then the initialised ``torch.distributed`` group's rank (the reference
reads ``JAX_PROCESS_INDEX`` / ``TPU_WORKER_ID`` and ``jax.process_index``).
The entry points also take any duck-typed context (``log_metrics``,
``log_result(s)``, ``log_artifact``, ``log_model``, ...); when it has no
``is_logging_worker``, the callbacks, ``Trainer.fit`` and ``auto_trainer``
ask :func:`logging_worker`, which falls back to :func:`is_logging_worker`.
"""

from __future__ import annotations

import os
import time
import traceback
from typing import Any, Optional

from .artifacts import (
    ArtifactManager,
    ArtifactProducer,
    DatasetArtifact,
    ModelArtifact,
)
from .chaos import fire as chaos_fire
from .common.runtimes_constants import RunStates
from .config import run_config
from .secrets import SecretsStore
from .utils.helpers import (
    generate_uid,
    now_date,
    now_iso,
    template_artifact_path,
)
from .utils.logger import logger

# checked in order; the first one set decides. torchrun's RANK is the
# global rank of this process (one per GPU), so a pod running eight
# processes has one logger, not eight
RANK_ENVS = ("RANK", "MLT_WORKER_RANK")


def is_logging_worker() -> bool:
    """True on exactly one process of a multi-process run: global rank 0
    by torchrun's ``RANK``, else ``MLT_WORKER_RANK``, else the
    initialised ``torch.distributed`` group's rank; True in a lone
    process."""
    for env in RANK_ENVS:
        if env in os.environ:
            return os.environ[env].split(":")[0] in ("0", "")
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank() == 0
    except Exception:  # noqa: BLE001 - any backend issue: one process
        pass
    return True


def logging_worker(context) -> bool:
    """``context.is_logging_worker()`` when the context has it, else
    :func:`is_logging_worker`."""
    check = getattr(context, "is_logging_worker", None)
    return bool(check()) if callable(check) else is_logging_worker()


class MLClientCtx:
    """Client context for a single run/iteration."""

    def __init__(self, autocommit: bool = False, tmp: str = "", log_stream=None):
        self._uid = None
        self.name = ""
        self.project = ""
        self.iteration = 0
        self.kind = "run"
        self.parameters: dict = {}
        self.labels: dict = {}
        self.annotations: dict = {}
        self._inputs: dict = {}
        self._outputs: list = []
        self._results: dict = {}
        self._state = RunStates.created
        self._error = None
        self._commit_text = ""
        self._secrets_manager = SecretsStore()
        self._autocommit = autocommit
        self._artifacts_manager: Optional[ArtifactManager] = None
        self._db = None
        self.artifact_path = ""
        self.in_path = ""
        self._function_uri = ""
        self._host = None
        self._start_time = now_date()
        self._last_update = now_date()
        self._last_heartbeat = now_date()
        self._heartbeat_wall = 0.0  # rate-limit for lightweight pushes
        self._checkpoint: Optional[dict] = None
        self._iteration_results = None
        self._state_thresholds = {}
        # carried through to_dict: the ctx's store_run replaces the whole
        # run doc, and dropping the policy (or the monitor-recorded retry
        # status) would silently disarm the service-side retry engine
        self._retry_policy = {}
        self._status_carry: dict = {}
        self._notifications = []
        self._logger = logger
        self._log_stream = log_stream
        self._updates_blocked = False

    # -- construction ------------------------------------------------------
    @classmethod
    def from_dict(cls, attrs: dict, rundb=None, autocommit: bool = False,
                  tmp: str = "", host: str | None = None,
                  log_stream=None, is_api: bool = False,
                  store_run: bool = True) -> "MLClientCtx":
        ctx = cls(autocommit=autocommit, tmp=tmp, log_stream=log_stream)
        meta = attrs.get("metadata", {})
        spec = attrs.get("spec", {})
        ctx._uid = meta.get("uid") or generate_uid()
        ctx.name = meta.get("name", "")
        ctx.project = meta.get("project") or run_config("default_project")
        ctx.iteration = meta.get("iteration", 0)
        ctx.labels = meta.get("labels", {})
        ctx.annotations = meta.get("annotations", {})
        ctx.parameters = spec.get("parameters", {})
        ctx._inputs = spec.get("inputs", {})
        ctx._outputs = spec.get("outputs", [])
        ctx.in_path = spec.get("input_path", "")
        ctx._function_uri = spec.get("function", "")
        ctx._state_thresholds = spec.get("state_thresholds", {})
        ctx._retry_policy = spec.get("retry_policy", {})
        # a resubmitted resource's exec config carries the retry status the
        # monitor recorded; the ctx's full-doc store_run must not erase it
        status = attrs.get("status", {}) or {}
        ctx._status_carry = {
            k: status[k] for k in ("retry_count", "failure_class")
            if k in status}
        if status.get("checkpoint") and not ctx._checkpoint:
            ctx._checkpoint = dict(status["checkpoint"])
        ctx._notifications = spec.get("notifications", [])
        ctx._secrets_manager = SecretsStore.from_list(spec.get("secret_sources"))
        ctx.artifact_path = template_artifact_path(
            spec.get("output_path", ""), ctx.project, ctx._uid)
        ctx._host = host
        if rundb is not None:
            ctx._db = rundb
        else:
            from .db import get_run_db

            ctx._db = get_run_db()
        ctx._artifacts_manager = ArtifactManager(db=ctx._db)
        if store_run and ctx.is_logging_worker():
            ctx._state = RunStates.running
            ctx._start_time = now_date()
            ctx.commit()
        return ctx

    # -- identity / info ---------------------------------------------------
    @property
    def uid(self) -> str:
        if self.iteration:
            return f"{self._uid}-{self.iteration}"
        return self._uid

    @property
    def tag(self) -> str:
        return self._uid

    @property
    def state(self) -> str:
        return self._state

    @property
    def results(self) -> dict:
        return dict(self._results)

    @property
    def logger(self):
        return self._logger

    @property
    def inputs(self) -> dict:
        return {k: self.get_input(k) for k in self._inputs}

    def get_meta(self) -> dict:
        return {
            "name": self.name, "kind": self.kind, "uri": self._function_uri,
            "owner": self.labels.get("owner"),
            "workflow": self.labels.get("workflow"),
        }

    def is_logging_worker(self) -> bool:
        """True on exactly one process of a multi-process run (torchrun's
        ``RANK`` 0, else ``MLT_WORKER_RANK`` 0, else the group's rank 0):
        :func:`is_logging_worker`."""
        return is_logging_worker()

    # -- params / inputs / secrets ----------------------------------------
    def get_param(self, key: str, default: Any = None) -> Any:
        if key in self.parameters:
            return self.parameters[key]
        self.parameters[key] = default
        return default

    def get_secret(self, key: str, default: Any = None) -> Any:
        return self._secrets_manager.get(key, default)

    def get_input(self, key: str, url: str = ""):
        url = url or self._inputs.get(key, "")
        if not url:
            return None
        if self.in_path and "://" not in url and not url.startswith("/"):
            url = os.path.join(self.in_path, url)
        from .datastore import store_manager

        return store_manager.object(url=url, key=key, project=self.project)

    def get_store_resource(self, url: str):
        from .datastore import store_manager

        return store_manager.object(url=url, project=self.project)

    def get_cached_artifact(self, key: str):
        return self._artifacts_manager.artifacts.get(key)

    def update_artifact(self, artifact):
        """Re-store an already-logged artifact after a spec mutation
        (e.g. the packagers manager recording unpackaging instructions)."""
        manager = self._artifacts_manager
        if manager.artifact_db:
            meta = artifact.metadata
            manager.artifact_db.store_artifact(
                artifact.spec.db_key or artifact.key, artifact.to_dict(),
                uid=meta.uid, iter=meta.iter, tag=meta.tag,
                project=meta.project, tree=meta.tree)
        manager.artifacts[artifact.key] = artifact
        self._update_db()

    def get_dataitem(self, url: str):
        return self.get_store_resource(url)

    # -- labels / state ----------------------------------------------------
    def set_label(self, key: str, value, replace: bool = True):
        if replace or key not in self.labels:
            self.labels[key] = str(value)

    def set_annotation(self, key: str, value, replace: bool = True):
        if replace or key not in self.annotations:
            self.annotations[key] = str(value)

    def set_state(self, execution_state: str | None = None, error: str | None = None,
                  commit: bool = True):
        if error is not None:
            self._state = RunStates.error
            self._error = str(error)
        elif execution_state:
            self._state = execution_state
        self._last_update = now_date()
        if commit:
            self.commit()

    def set_hostname(self, host: str):
        self._host = host

    # -- results / artifacts ----------------------------------------------
    def log_result(self, key: str, value, commit: bool = False):
        self._results[key] = _cast_result(value)
        if commit or self._autocommit:
            self.commit()

    def log_results(self, results: dict, commit: bool = False):
        for key, value in results.items():
            self._results[key] = _cast_result(value)
        if commit or self._autocommit:
            self.commit()

    def log_metrics(self, metrics: dict, step: int | None = None):
        """Log per-step training metrics as results (flat, last-value-wins) and
        append to the metrics stream artifact."""
        for key, value in metrics.items():
            self._results[key] = _cast_result(value)
        self.heartbeat()

    def heartbeat(self, force: bool = False):
        """Push ``status.last_heartbeat`` so the service's stall watchdog
        can tell a slow run from a hung
        one. Rate-limited to ``RUN_DEFAULTS["heartbeat_interval"]`` so
        per-step metric logging doesn't turn into per-step DB writes; a
        failed push never breaks the training loop."""
        self._last_heartbeat = now_date()
        interval = float(run_config("heartbeat_interval"))
        now = time.monotonic()
        if not force and now - self._heartbeat_wall < interval:
            return
        self._heartbeat_wall = now
        self._push_status_fields(
            {"status.last_heartbeat": str(self._last_heartbeat)})

    def _push_status_fields(self, fields: dict):
        """Best-effort lightweight status write (no full-doc commit) —
        shared by heartbeat() and log_checkpoint(); a failed push never
        breaks the training loop."""
        if self._db is None or not self.is_logging_worker():
            return
        updater = getattr(self._db, "update_run", None)
        if updater is None:
            return
        try:
            updater(fields, self._uid, self.project, iter=self.iteration)
        except Exception:  # noqa: BLE001 - status push is best-effort
            pass

    def log_checkpoint(self, path: str, step: int | None = None,
                       commit: bool = False):
        """Record the latest resumable checkpoint on ``status.checkpoint``
        — the service monitor reads it when resubmitting a preempted run
        so the replacement JobSet resumes from this step instead of
        restarting. Without ``commit``
        the checkpoint still reaches the DB as a lightweight field update:
        it is exactly what a hard-killed run needs recorded, so it must
        not wait for the next full-doc commit that may never come."""
        self._checkpoint = {"path": str(path),
                            "step": int(step) if step is not None else None,
                            "time": now_iso()}
        if commit:
            self.commit()
            return
        self._push_status_fields(
            {"status.checkpoint": dict(self._checkpoint)})

    def log_iteration_results(self, best: int, summary: list, task: dict,
                              commit: bool = False):
        self._results["best_iteration"] = best
        self._iteration_results = summary
        if commit or self._autocommit:
            self.commit()

    def _producer(self) -> ArtifactProducer:
        return ArtifactProducer(
            "run", self.project, self.name, tag=self.tag,
            owner=self.labels.get("owner"), uid=self._uid)

    def log_artifact(self, item, body=None, local_path: str = "",
                     artifact_path: str = "", tag: str = "", viewer: str = "",
                     target_path: str = "", format: str | None = None,
                     upload: bool | None = None, labels: dict | None = None,
                     db_key: str | None = None,
                     unpackaging_instructions: dict | None = None,
                     **kwargs):
        artifact = self._artifacts_manager.log_artifact(
            self._producer(), item, body=body, local_path=local_path,
            artifact_path=artifact_path or self.artifact_path, tag=tag,
            viewer=viewer, target_path=target_path, format=format,
            upload=upload, labels=labels, db_key=db_key,
            unpackaging_instructions=unpackaging_instructions, **kwargs)
        self._update_db()
        return artifact

    def log_dataset(self, key: str, df, tag: str = "", local_path: str = "",
                    artifact_path: str = "", upload: bool | None = None,
                    labels: dict | None = None, format: str = "parquet",
                    preview=None, stats=None, target_path: str = "", **kwargs):
        ds = DatasetArtifact(key, df=df, preview=preview, format=format,
                             stats=stats, target_path=target_path)
        artifact = self._artifacts_manager.log_artifact(
            self._producer(), ds, local_path=local_path,
            artifact_path=artifact_path or self.artifact_path, tag=tag,
            upload=upload, labels=labels, **kwargs)
        self._update_db()
        return artifact

    def log_model(self, key: str, body=None, framework: str = "",
                  tag: str = "", model_dir: str = "", model_file: str = "",
                  algorithm: str = "", metrics: dict | None = None,
                  parameters: dict | None = None, artifact_path: str = "",
                  upload: bool | None = None, labels: dict | None = None,
                  inputs: list | None = None, outputs: list | None = None,
                  feature_vector: str | None = None,
                  feature_weights: list | None = None,
                  training_set=None, label_column: str | None = None,
                  extra_data: dict | None = None, db_key: str | None = None,
                  **kwargs):
        if training_set is not None and inputs is None:
            inputs = [
                {"name": c, "value_type": str(training_set[c].dtype)}
                for c in training_set.columns if c != label_column
            ]
            if label_column and outputs is None:
                outputs = [{
                    "name": label_column,
                    "value_type": str(training_set[label_column].dtype),
                }]
        model = ModelArtifact(
            key, body=body, model_file=model_file, model_dir=model_dir,
            metrics=metrics, parameters=parameters, inputs=inputs,
            outputs=outputs, framework=framework, algorithm=algorithm,
            feature_vector=feature_vector, feature_weights=feature_weights,
            extra_data=extra_data)
        artifact = self._artifacts_manager.log_artifact(
            self._producer(), model, artifact_path=artifact_path or self.artifact_path,
            tag=tag, upload=upload, labels=labels, db_key=db_key, **kwargs)
        self._update_db()
        return artifact

    # -- persistence -------------------------------------------------------
    def to_dict(self) -> dict:
        struct = {
            "kind": "run",
            "metadata": {
                "name": self.name, "uid": self._uid, "iteration": self.iteration,
                "project": self.project, "labels": self.labels,
                "annotations": self.annotations,
            },
            "spec": {
                "function": self._function_uri,
                "parameters": self.parameters,
                "inputs": self._inputs,
                "outputs": self._outputs,
                "output_path": self.artifact_path,
                "input_path": self.in_path,
                "state_thresholds": self._state_thresholds,
                "retry_policy": self._retry_policy,
                "notifications": self._notifications,
                "secret_sources": self._secrets_manager.to_serial(),
            },
            "status": {
                "state": self._state,
                "results": self._results,
                "start_time": str(self._start_time),
                "last_update": str(self._last_update),
                "last_heartbeat": str(self._last_heartbeat),
                "artifacts": self._artifacts_manager.artifact_list(full=True)
                if self._artifacts_manager else [],
                "artifact_uris": dict(self._artifacts_manager.artifact_uris)
                if self._artifacts_manager else {},
            },
        }
        struct["status"].update(self._status_carry)
        if self._checkpoint:
            struct["status"]["checkpoint"] = dict(self._checkpoint)
        if self._error:
            struct["status"]["error"] = self._error
        if self._host:
            struct["status"]["host"] = self._host
        if self._iteration_results is not None:
            struct["status"]["iterations"] = self._iteration_results
        return struct

    def to_json(self) -> str:
        import json

        return json.dumps(self.to_dict(), default=str)

    def _update_db(self):
        # artifact logs always round-trip the run doc to the DB (the run DB
        # is the source of truth)
        self.commit()

    def commit(self, message: str = "", completed: bool = False):
        if message:
            self._commit_text = message
        if completed:
            self._state = RunStates.completed
        self._last_update = now_date()
        # every commit doubles as a heartbeat (the full doc carries
        # last_heartbeat); the named fault point lets chaos tests stall or
        # fail the in-run status path on demand
        self._last_heartbeat = self._last_update
        chaos_fire("execution.commit", uid=self._uid, project=self.project)
        if self._db and self.is_logging_worker():
            self._db.store_run(self.to_dict(), self._uid, self.project,
                               iter=self.iteration)

    def commit_results(self):
        self.commit()

    def mark_as_best(self):
        self.set_label("best_iteration", "true")

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc_value, exc_traceback):
        if exc_value is not None:
            self.set_state(error=f"{exc_value}\n"
                           + "".join(traceback.format_exception(
                               exc_type, exc_value, exc_traceback))[-2000:])
        else:
            self.commit(completed=True)
        return False


def _cast_result(value):
    import numpy as np

    if isinstance(value, (np.integer,)):
        return int(value)
    if isinstance(value, (np.floating,)):
        return float(value)
    if isinstance(value, np.ndarray):
        return value.tolist()
    if hasattr(value, "item") and getattr(value, "ndim", None) == 0:
        # 0-d torch tensors (and any 0-d array with .item())
        try:
            return value.item()
        except Exception:  # noqa: BLE001
            return str(value)
    return value
