"""Run-db interface — the port's copy of ``mlrun_tpu/db/base.py``.

Implementations: ``SQLiteRunDB`` (embedded) and ``NopDB`` (nothing kept).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Optional


class RunDBError(Exception):
    pass


def sql_dialect_for_dsn(dsn: str) -> str | None:
    """'postgresql' / 'mysql' when the dsn selects the server-grade SQL
    backend, else None — the one place the scheme list lives."""
    scheme = (dsn or "").partition("://")[0].split("+")[0]
    if scheme in ("postgresql", "postgres"):
        return "postgresql"
    if scheme in ("mysql", "mariadb"):
        return "mysql"
    return None


class RunDBInterface(ABC):
    kind = ""

    def connect(self, secrets=None):
        return self

    # -- runs --------------------------------------------------------------
    @abstractmethod
    def store_run(self, struct: dict, uid: str, project: str = "", iter: int = 0):
        ...

    @abstractmethod
    def update_run(self, updates: dict, uid: str, project: str = "", iter: int = 0):
        ...

    @abstractmethod
    def read_run(self, uid: str, project: str = "", iter: int = 0) -> dict:
        ...

    @abstractmethod
    def list_runs(self, name: str = "", uid=None, project: str = "", labels=None,
                  state: str = "", sort: bool = True, last: int = 0,
                  iter: bool = False, start_time_from=None, start_time_to=None) -> list:
        ...

    @abstractmethod
    def del_run(self, uid: str, project: str = "", iter: int = 0):
        ...

    def abort_run(self, uid: str, project: str = "", iter: int = 0,
                  status_text: str = ""):
        from ..common.runtimes_constants import RunStates

        updates = {"status.state": RunStates.aborted}
        if status_text:
            updates["status.status_text"] = status_text
        self.update_run(updates, uid, project, iter)

    # -- logs --------------------------------------------------------------
    @abstractmethod
    def store_log(self, uid: str, project: str = "", body: bytes = b"",
                  append: bool = True):
        ...

    @abstractmethod
    def get_log(self, uid: str, project: str = "", offset: int = 0,
                size: int = -1) -> tuple[str, bytes]:
        ...

    def watch_log(self, uid: str, project: str = "", watch: bool = True,
                  offset: int = 0) -> tuple[str, int]:
        import sys
        import time

        from ..common.runtimes_constants import RunStates

        state, text = self.get_log(uid, project, offset=offset)
        if text:
            print(text.decode(errors="replace"), end="")
            offset += len(text)
        if watch:
            while state not in RunStates.terminal_states():
                time.sleep(1)
                state, text = self.get_log(uid, project, offset=offset)
                if text:
                    print(text.decode(errors="replace"), end="")
                    sys.stdout.flush()
                    offset += len(text)
        return state, offset

    # -- artifacts ---------------------------------------------------------
    @abstractmethod
    def store_artifact(self, key: str, artifact: dict, uid=None, iter=None,
                       tag: str = "", project: str = "", tree=None):
        ...

    @abstractmethod
    def read_artifact(self, key: str, tag=None, iter=None, project: str = "",
                      tree=None, uid=None) -> dict:
        ...

    @abstractmethod
    def list_artifacts(self, name: str = "", project: str = "", tag=None,
                       labels=None, since=None, until=None, kind=None,
                       category=None, tree=None) -> list:
        ...

    @abstractmethod
    def del_artifact(self, key: str, tag=None, project: str = "", uid=None):
        ...

    def del_artifacts(self, name: str = "", project: str = "", tag=None,
                      labels=None):
        for artifact in self.list_artifacts(name, project, tag, labels):
            key = artifact.get("metadata", {}).get("key") or artifact.get("spec", {}).get("db_key")
            if key:
                self.del_artifact(key, tag=tag, project=project)

    # -- functions ---------------------------------------------------------
    @abstractmethod
    def store_function(self, function: dict, name: str, project: str = "",
                       tag: str = "", versioned: bool = False) -> str:
        ...

    @abstractmethod
    def get_function(self, name: str, project: str = "", tag: str = "",
                     hash_key: str = "") -> dict:
        ...

    @abstractmethod
    def list_functions(self, name: str = "", project: str = "", tag: str = "",
                       labels=None) -> list:
        ...

    @abstractmethod
    def delete_function(self, name: str, project: str = ""):
        ...

    # -- projects ----------------------------------------------------------
    @abstractmethod
    def store_project(self, name: str, project: dict) -> dict:
        ...

    @abstractmethod
    def get_project(self, name: str) -> Optional[dict]:
        ...

    @abstractmethod
    def list_projects(self, owner=None, labels=None, state=None) -> list:
        ...

    @abstractmethod
    def delete_project(self, name: str, deletion_strategy: str = "restricted"):
        ...

    # -- schedules ---------------------------------------------------------
    def store_schedule(self, project: str, name: str, schedule: dict):
        raise NotImplementedError

    def get_schedule(self, project: str, name: str) -> dict:
        raise NotImplementedError

    def list_schedules(self, project: str = "") -> list:
        raise NotImplementedError

    def delete_schedule(self, project: str, name: str):
        raise NotImplementedError

    # -- feature store ------------------------------------------------------
    def store_feature_set(self, feature_set: dict, name=None, project="",
                          tag=None, uid=None, versioned=True):
        raise NotImplementedError

    def get_feature_set(self, name: str, project: str = "", tag=None, uid=None):
        raise NotImplementedError

    def list_feature_sets(self, project: str = "", name: str = "", tag=None,
                          labels=None):
        raise NotImplementedError

    def delete_feature_set(self, name, project="", tag=None, uid=None):
        raise NotImplementedError

    def store_feature_vector(self, feature_vector: dict, name=None, project="",
                             tag=None, uid=None, versioned=True):
        raise NotImplementedError

    def get_feature_vector(self, name: str, project: str = "", tag=None, uid=None):
        raise NotImplementedError

    def list_feature_vectors(self, project: str = "", name: str = "", tag=None,
                             labels=None):
        raise NotImplementedError

    def delete_feature_vector(self, name, project="", tag=None, uid=None):
        raise NotImplementedError

    # -- model endpoints (monitoring) ---------------------------------------
    def store_model_endpoint(self, project: str, endpoint_id: str, endpoint: dict):
        raise NotImplementedError

    def get_model_endpoint(self, project: str, endpoint_id: str) -> dict:
        raise NotImplementedError

    def list_model_endpoints(self, project: str = "", model: str = "",
                             function: str = "", state: str = "") -> list:
        raise NotImplementedError

    def delete_model_endpoint(self, project: str, endpoint_id: str):
        raise NotImplementedError

    # -- alerts / events ----------------------------------------------------
    def store_alert_config(self, name: str, config: dict, project: str = ""):
        raise NotImplementedError

    def get_alert_config(self, name: str, project: str = "") -> dict:
        raise NotImplementedError

    def list_alert_configs(self, project: str = "") -> list:
        raise NotImplementedError

    def delete_alert_config(self, name: str, project: str = ""):
        raise NotImplementedError

    def emit_event(self, kind: str, event: dict, project: str = ""):
        raise NotImplementedError

    # -- misc ---------------------------------------------------------------
    def submit_job(self, runspec, schedule=None) -> dict:
        raise NotImplementedError

    def remote_builder(self, func, with_gpu: bool = False) -> dict:
        raise NotImplementedError

    def get_builder_status(self, func, offset=0, logs=True):
        raise NotImplementedError

    def api_call(self, method, path, error=None, params=None, body=None, json=None):
        raise NotImplementedError
