"""HTTP run-DB client — the port's copy of ``mlrun_tpu/db/httpdb.py``
(reference analog: mlrun/db/httpdb.py:78 HTTPRunDB — retrying session
:366, full REST surface :685+).

Talks to the aiohttp service (``service/app.py``, either package's: both
speak one ``/api/v1`` REST contract over one SQLite schema).
"""

from __future__ import annotations

import json
import time
from typing import Optional
from urllib.parse import quote

import requests
import requests.adapters

from ..chaos import FaultPoints
from ..chaos import fire as chaos_fire
from ..config import run_config, service_config
from ..utils import logger
from .base import RunDBError, RunDBInterface


class HTTPRunDB(RunDBInterface):
    kind = "http"

    def __init__(self, url: str, token: str = ""):
        self.base_url = url.rstrip("/")
        self.user = service_config("httpdb.user")
        self.token = token or service_config("httpdb.token")
        self._session: Optional[requests.Session] = None
        self.server_version = ""

    def __repr__(self):
        return f"HTTPRunDB({self.base_url})"

    @property
    def _api(self) -> str:
        return self.base_url + service_config("api_base_path")

    # -- plumbing ----------------------------------------------------------
    @property
    def session(self) -> requests.Session:
        if self._session is None:
            session = requests.Session()
            retry = requests.adapters.Retry(
                total=service_config("httpdb.retries"),
                backoff_factor=service_config("httpdb.retry_backoff"),
                status_forcelist=[500, 502, 503, 504],
                allowed_methods=["GET", "PUT", "DELETE", "POST"],
            )
            adapter = requests.adapters.HTTPAdapter(max_retries=retry)
            session.mount("http://", adapter)
            session.mount("https://", adapter)
            self._session = session
        return self._session

    def api_call(self, method: str, path: str, error: str | None = None,
                 params: dict | None = None, body=None, json_body=None,
                 timeout: float | None = None, json: dict | None = None,
                 raw: bool = False):
        url = f"{self._api}/{path.lstrip('/')}"
        headers = {}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        try:
            # chaos fault point: an injected requests.RequestException
            # simulates a dead/5xx-ing control plane after client retries
            chaos_fire(FaultPoints.httpdb_request, method=method, path=path,
                       url=url)
            resp = self.session.request(
                method, url, params=params, data=body,
                json=json_body if json_body is not None else json,
                headers=headers,
                timeout=timeout or service_config("httpdb.timeout"))
        except requests.RequestException as exc:
            raise RunDBError(
                f"{error or 'api call failed'}: {method} {url}: {exc}") from exc
        if not resp.ok:
            detail = ""
            try:
                detail = resp.json().get("detail", resp.text)
            except ValueError:
                detail = resp.text
            raise RunDBError(
                f"{error or 'api call failed'}: {method} {url} "
                f"[{resp.status_code}]: {detail}")
        if raw:
            return resp.content
        if resp.content:
            try:
                return resp.json()
            except ValueError:
                return resp.content
        return {}

    def connect(self, secrets=None):
        try:
            resp = self.api_call("GET", "client-spec", "connect failed")
            spec = resp or {}
            self.server_version = spec.get("version", "")
        except RunDBError as exc:
            logger.warning("could not fetch client spec", error=str(exc))
        return self

    @staticmethod
    def _path(project: str, kind: str, *parts) -> str:
        project = project or run_config("default_project")
        tail = "/".join(quote(str(p), safe="") for p in parts if p is not None)
        return f"projects/{project}/{kind}" + (f"/{tail}" if tail else "")

    # -- runs --------------------------------------------------------------
    def store_run(self, struct, uid, project="", iter=0):
        self.api_call("POST", self._path(project, "runs", uid),
                      "store run", params={"iter": iter}, json_body=struct)

    def update_run(self, updates, uid, project="", iter=0):
        self.api_call("PATCH", self._path(project, "runs", uid),
                      "update run", params={"iter": iter}, json_body=updates)

    def read_run(self, uid, project="", iter=0):
        resp = self.api_call("GET", self._path(project, "runs", uid),
                             "read run", params={"iter": iter})
        return resp.get("data")

    def list_runs(self, name="", uid=None, project="", labels=None, state="",
                  sort=True, last=0, iter=False, start_time_from=None,
                  start_time_to=None):
        params = {"name": name, "state": state, "last": last,
                  "iter": int(iter)}
        if uid:
            params["uid"] = uid
        if labels:
            params["label"] = labels if isinstance(labels, list) else [
                f"{k}={v}" for k, v in labels.items()]
        resp = self.api_call("GET", self._path(project, "runs"), "list runs",
                             params=params)
        return resp.get("runs", [])

    @staticmethod
    def _encode_list_filters(filters: dict) -> dict:
        """Map pythonic filter kwargs onto the server's query encoding
        (same mapping list_runs/list_artifacts use inline)."""
        params = dict(filters)
        labels = params.pop("labels", None)
        if labels:
            params["label"] = labels if isinstance(labels, list) else [
                f"{k}={v}" for k, v in labels.items()]
        if "iter" in params:
            params["iter"] = int(bool(params["iter"]))
        return {k: v for k, v in params.items() if v not in (None, "")}

    def paginated_list_runs(self, project="", page_size=20, page_token="",
                            **filters) -> tuple[list, str | None]:
        """Token-paginated listing (reference httpdb.py:304). Returns
        (runs, next_token); pass next_token back until it is None."""
        params = self._encode_list_filters(filters)
        params["page_size"] = page_size
        if page_token:
            params["page_token"] = page_token
        resp = self.api_call("GET", self._path(project, "runs"),
                             "list runs", params=params)
        return (resp.get("runs", []),
                (resp.get("pagination") or {}).get("page_token"))

    def paginated_list_artifacts(self, project="", page_size=20,
                                 page_token="", **filters
                                 ) -> tuple[list, str | None]:
        params = self._encode_list_filters(filters)
        params["page_size"] = page_size
        if page_token:
            params["page_token"] = page_token
        resp = self.api_call("GET", self._path(project, "artifacts"),
                             "list artifacts", params=params)
        return (resp.get("artifacts", []),
                (resp.get("pagination") or {}).get("page_token"))

    def del_run(self, uid, project="", iter=0):
        self.api_call("DELETE", self._path(project, "runs", uid), "del run",
                      params={"iter": iter})

    def abort_run(self, uid, project="", iter=0, status_text=""):
        self.api_call("POST", self._path(project, "runs", uid) + "/abort",
                      "abort run", json_body={"status_text": status_text})

    # -- logs --------------------------------------------------------------
    def store_log(self, uid, project="", body=b"", append=True):
        if isinstance(body, str):
            body = body.encode()
        self.api_call("POST", self._path(project, "logs", uid), "store log",
                      params={"append": int(append)}, body=body)

    def get_log(self, uid, project="", offset=0, size=-1):
        url = f"{self._api}/" + self._path(project, "logs", uid)
        resp = self.session.get(
            url, params={"offset": offset, "size": size},
            timeout=service_config("httpdb.timeout"))
        if not resp.ok:
            raise RunDBError(f"get log failed [{resp.status_code}]")
        state = resp.headers.get("x-mlt-run-state", "unknown")
        return state, resp.content

    # -- artifacts ---------------------------------------------------------
    def store_artifact(self, key, artifact, uid=None, iter=None, tag="",
                       project="", tree=None):
        self.api_call(
            "POST", self._path(project, "artifacts", key), "store artifact",
            params={"uid": uid, "iter": iter, "tag": tag, "tree": tree},
            json_body=artifact)

    def read_artifact(self, key, tag=None, iter=None, project="", tree=None,
                      uid=None):
        resp = self.api_call(
            "GET", self._path(project, "artifacts", key), "read artifact",
            params={"tag": tag, "iter": iter, "tree": tree, "uid": uid})
        return resp.get("data")

    def list_artifacts(self, name="", project="", tag=None, labels=None,
                       since=None, until=None, kind=None, category=None,
                       tree=None):
        params = {"name": name, "tag": tag, "kind": kind, "tree": tree}
        if labels:
            params["label"] = labels if isinstance(labels, list) else [
                f"{k}={v}" for k, v in labels.items()]
        resp = self.api_call("GET", self._path(project, "artifacts"),
                             "list artifacts", params=params)
        return resp.get("artifacts", [])

    def del_artifact(self, key, tag=None, project="", uid=None):
        self.api_call("DELETE", self._path(project, "artifacts", key),
                      "del artifact", params={"tag": tag, "uid": uid})

    # -- functions ---------------------------------------------------------
    def store_function(self, function, name, project="", tag="",
                       versioned=False):
        resp = self.api_call(
            "POST", self._path(project, "functions", name), "store function",
            params={"tag": tag, "versioned": int(versioned)},
            json_body=function)
        return resp.get("hash_key", "")

    def get_function(self, name, project="", tag="", hash_key=""):
        resp = self.api_call(
            "GET", self._path(project, "functions", name), "get function",
            params={"tag": tag, "hash_key": hash_key})
        return resp.get("func")

    def list_functions(self, name="", project="", tag="", labels=None):
        params = {"name": name, "tag": tag}
        if labels:
            params["label"] = labels if isinstance(labels, list) else [
                f"{k}={v}" for k, v in labels.items()]
        resp = self.api_call("GET", self._path(project, "functions"),
                             "list functions", params=params)
        return resp.get("funcs", [])

    def delete_function(self, name, project=""):
        self.api_call("DELETE", self._path(project, "functions", name),
                      "delete function")

    # -- projects ----------------------------------------------------------
    def store_project(self, name, project):
        resp = self.api_call("POST", f"projects/{name}", "store project",
                             json_body=project)
        return resp.get("data", project)

    def get_project(self, name):
        try:
            resp = self.api_call("GET", f"projects/{name}", "get project")
        except RunDBError as exc:
            if "[404]" in str(exc):
                return None
            raise
        return resp.get("data")

    def list_projects(self, owner=None, labels=None, state=None):
        resp = self.api_call("GET", "projects", "list projects",
                             params={"state": state})
        return resp.get("projects", [])

    def delete_project(self, name, deletion_strategy="restricted"):
        self.api_call("DELETE", f"projects/{name}", "delete project",
                      params={"deletion_strategy": deletion_strategy})

    # -- schedules ---------------------------------------------------------
    def store_schedule(self, project, name, schedule):
        self.api_call("POST", self._path(project, "schedules", name),
                      "store schedule", json_body=schedule)

    def get_schedule(self, project, name):
        resp = self.api_call("GET", self._path(project, "schedules", name),
                             "get schedule")
        return resp.get("data")

    def list_schedules(self, project=""):
        resp = self.api_call("GET", self._path(project, "schedules"),
                             "list schedules")
        return resp.get("schedules", [])

    def delete_schedule(self, project, name):
        self.api_call("DELETE", self._path(project, "schedules", name),
                      "delete schedule")

    # -- feature store ------------------------------------------------------
    def store_feature_set(self, feature_set, name=None, project="", tag=None,
                          uid=None, versioned=True):
        name = name or feature_set.get("metadata", {}).get("name")
        resp = self.api_call(
            "POST", self._path(project, "feature-sets", name),
            "store feature set", params={"tag": tag, "uid": uid},
            json_body=feature_set)
        return resp.get("uid", "")

    def get_feature_set(self, name, project="", tag=None, uid=None):
        resp = self.api_call(
            "GET", self._path(project, "feature-sets", name),
            "get feature set", params={"tag": tag, "uid": uid})
        return resp.get("data")

    def list_feature_sets(self, project="", name="", tag=None, labels=None):
        resp = self.api_call("GET", self._path(project, "feature-sets"),
                             "list feature sets",
                             params={"name": name, "tag": tag})
        return resp.get("feature_sets", [])

    def delete_feature_set(self, name, project="", tag=None, uid=None):
        self.api_call("DELETE", self._path(project, "feature-sets", name),
                      "delete feature set")

    def store_feature_vector(self, feature_vector, name=None, project="",
                             tag=None, uid=None, versioned=True):
        name = name or feature_vector.get("metadata", {}).get("name")
        resp = self.api_call(
            "POST", self._path(project, "feature-vectors", name),
            "store feature vector", params={"tag": tag, "uid": uid},
            json_body=feature_vector)
        return resp.get("uid", "")

    def get_feature_vector(self, name, project="", tag=None, uid=None):
        resp = self.api_call(
            "GET", self._path(project, "feature-vectors", name),
            "get feature vector", params={"tag": tag, "uid": uid})
        return resp.get("data")

    def list_feature_vectors(self, project="", name="", tag=None, labels=None):
        resp = self.api_call("GET", self._path(project, "feature-vectors"),
                             "list feature vectors",
                             params={"name": name, "tag": tag})
        return resp.get("feature_vectors", [])

    def delete_feature_vector(self, name, project="", tag=None, uid=None):
        self.api_call("DELETE", self._path(project, "feature-vectors", name),
                      "delete feature vector")

    # -- model endpoints ----------------------------------------------------
    def store_model_endpoint(self, project, endpoint_id, endpoint):
        self.api_call("POST",
                      self._path(project, "model-endpoints", endpoint_id),
                      "store model endpoint", json_body=endpoint)

    def get_model_endpoint(self, project, endpoint_id):
        resp = self.api_call(
            "GET", self._path(project, "model-endpoints", endpoint_id),
            "get model endpoint")
        return resp.get("data")

    def list_model_endpoints(self, project="", model="", function="", state=""):
        resp = self.api_call(
            "GET", self._path(project, "model-endpoints"),
            "list model endpoints",
            params={"model": model, "function": function, "state": state})
        return resp.get("endpoints", [])

    def delete_model_endpoint(self, project, endpoint_id):
        self.api_call("DELETE",
                      self._path(project, "model-endpoints", endpoint_id),
                      "delete model endpoint")

    def get_model_endpoint_metrics(self, project, endpoint_id, name="",
                                   start: float = 0, end=None,
                                   max_points: int = 1000) -> list[dict]:
        """Metric time-series for an endpoint (reference: model-endpoint
        metric-values API over the TSDB layer)."""
        params = {"name": name, "start": start,
                  "max_points": max_points}
        if end is not None:
            params["end"] = end
        resp = self.api_call(
            "GET",
            self._path(project, "model-endpoints", endpoint_id, "metrics"),
            "endpoint metrics", params=params)
        return resp.get("series", [])

    def list_model_endpoint_metric_names(self, project,
                                         endpoint_id) -> list[str]:
        resp = self.api_call(
            "GET",
            self._path(project, "model-endpoints", endpoint_id, "metrics"),
            "endpoint metric names", params={"names_only": "true"})
        return resp.get("metrics", [])

    def list_background_tasks(self, project=""):
        resp = self.api_call(
            "GET", self._path(project, "background-tasks"),
            "list background tasks")
        return resp.get("background_tasks", [])

    # -- tags (reference mlrun/db/httpdb.py:2722 tag_objects) ---------------
    def tag_objects(self, project, tag, identifiers, kind="artifact"):
        """Apply ``tag`` to the identified objects (artifact key[/uid])."""
        resp = self.api_call(
            "POST", self._path(project, "tags", tag), "tag objects",
            json_body={"kind": kind, "identifiers": identifiers})
        return resp.get("tagged", 0)

    def delete_objects_tag(self, project, tag, identifiers,
                           kind="artifact"):
        resp = self.api_call(
            "DELETE", self._path(project, "tags", tag), "untag objects",
            json_body={"kind": kind, "identifiers": identifiers})
        return resp.get("removed", 0)

    # -- files --------------------------------------------------------------
    def get_file(self, path, project="", size=None, offset=0) -> bytes:
        """Read a file through the service's datastore (server-side
        credentials/profiles apply)."""
        params = {"path": path, "offset": str(offset)}
        if size:
            params["size"] = str(size)
        return self.api_call("GET", self._path(project, "files"),
                             "get file", params=params, raw=True)

    def get_filestat(self, path, project=""):
        return self.api_call("GET", self._path(project, "filestat"),
                             "stat file", params={"path": path})

    # -- hub admin ----------------------------------------------------------
    def store_hub_source(self, name, source: dict, order: int = -1):
        resp = self.api_call("PUT", f"hub/sources/{name}",
                             "store hub source",
                             json_body={"source": source, "order": order})
        return resp.get("data")

    def list_hub_sources(self):
        return self.api_call("GET", "hub/sources",
                             "list hub sources").get("sources", [])

    def get_hub_source(self, name):
        return self.api_call("GET", f"hub/sources/{name}",
                             "get hub source").get("data")

    def delete_hub_source(self, name):
        self.api_call("DELETE", f"hub/sources/{name}", "delete hub source")

    def get_hub_catalog(self, source_name: str):
        return self.api_call(
            "GET", f"hub/sources/{source_name}/items",
            "hub catalog").get("catalog", [])

    def get_hub_item(self, source_name: str, item: str):
        return self.api_call(
            "GET", f"hub/sources/{source_name}/items/{item}",
            "hub item").get("data")

    # -- alerts -------------------------------------------------------------
    def store_alert_config(self, name, config, project=""):
        self.api_call("POST", self._path(project, "alerts", name),
                      "store alert", json_body=config)

    def silence_alert(self, name, minutes: float, project=""):
        """Silence an alert for ``minutes`` (0 clears the window)."""
        resp = self.api_call(
            "POST", self._path(project, "alerts", name) + "/silence",
            "silence alert", json_body={"minutes": minutes})
        return resp.get("data")

    def get_alert_config(self, name, project=""):
        resp = self.api_call("GET", self._path(project, "alerts", name),
                             "get alert")
        return resp.get("data")

    def list_alert_configs(self, project=""):
        resp = self.api_call("GET", self._path(project, "alerts"),
                             "list alerts")
        return resp.get("alerts", [])

    def delete_alert_config(self, name, project=""):
        self.api_call("DELETE", self._path(project, "alerts", name),
                      "delete alert")

    def emit_event(self, kind, event, project=""):
        self.api_call("POST", self._path(project, "events", kind),
                      "emit event", json_body=event)

    # -- project secrets (reference mlrun/db/httpdb.py:3034-3232; values
    # are write-only over HTTP — list returns key names only) --------------
    def create_project_secrets(self, project: str, secrets: dict,
                               provider: str = "kubernetes"):
        self.api_call(
            "POST", self._path(project, "secrets"), "store secrets",
            json_body={"provider": provider, "secrets": secrets})

    # same operation under the server-side store's name, so code written
    # against either db implementation (e.g. notification masking) works
    store_project_secrets = create_project_secrets

    def list_project_secret_keys(self, project: str,
                                 provider: str = "kubernetes") -> list[str]:
        resp = self.api_call(
            "GET", self._path(project, "secret-keys"), "list secret keys",
            params={"provider": provider})
        return resp.get("secret_keys", [])

    def delete_project_secrets(self, project: str,
                               secrets: list | None = None,
                               provider: str = "kubernetes"):
        if secrets is not None and not secrets:
            return  # an empty key list deletes nothing (None deletes all)
        params: dict = {"provider": provider}
        if secrets is not None:
            params["secret"] = secrets
        self.api_call("DELETE", self._path(project, "secrets"),
                      "delete secrets", params=params)

    # -- datastore profiles -------------------------------------------------
    def store_datastore_profile(self, profile: dict, project: str = "",
                                private: dict | None = None):
        self.api_call(
            "PUT",
            self._path(project, "datastore-profiles", profile["name"]),
            "store datastore profile",
            json_body={"profile": profile, "private": private})

    def get_datastore_profile(self, name: str, project: str = ""
                              ) -> dict | None:
        try:
            resp = self.api_call(
                "GET", self._path(project, "datastore-profiles", name),
                "get datastore profile")
        except RunDBError as exc:
            if "not found" in str(exc):
                return None  # same missing-profile contract as SQLiteRunDB
            raise
        return resp.get("data")

    def list_datastore_profiles(self, project: str = "") -> list[dict]:
        resp = self.api_call(
            "GET", self._path(project, "datastore-profiles"),
            "list datastore profiles")
        return resp.get("datastore_profiles", [])

    def delete_datastore_profile(self, name: str, project: str = ""):
        self.api_call(
            "DELETE", self._path(project, "datastore-profiles", name),
            "delete datastore profile")

    # -- submit / build -----------------------------------------------------
    def submit_job(self, runspec: dict, schedule=None) -> dict:
        body = dict(runspec)
        if schedule:
            body["schedule"] = schedule
        return self.api_call("POST", "submit_job", "submit job",
                             json_body=body,
                             timeout=max(service_config("httpdb.timeout"),
                                         120))

    def submit_pipeline(self, project, pipeline, arguments=None,
                        experiment=None, run=None, namespace=None,
                        artifact_path=None, ops=None) -> str:
        resp = self.api_call(
            "POST", self._path(project, "workflows") + "/submit",
            "submit pipeline",
            json_body={"pipeline": pipeline, "arguments": arguments or {},
                       "artifact_path": artifact_path})
        return resp.get("id", "")

    def list_pipelines(self, project: str = "*") -> dict:
        """Reference: mlrun/db/httpdb.py submit/list pipelines proxy."""
        return self.api_call(
            "GET", self._path(project or "*", "pipelines"), "list pipelines")

    def get_pipeline(self, run_id: str, project: str = "*") -> dict:
        return self.api_call(
            "GET", self._path(project or "*", "pipelines", run_id),
            "get pipeline")

    def list_runtime_resources(self, project: str = "*",
                               kind: str = "") -> list[dict]:
        """Reference: mlrun/db/httpdb.py list_runtime_resources — grouped
        per-kind cluster resources for a project ('*' = all)."""
        params = {"kind": kind} if kind else None
        resp = self.api_call(
            "GET", self._path(project or "*", "runtime-resources"),
            "list runtime resources", params=params)
        return resp.get("runtime_resources", [])

    def delete_runtime_resources(self, project: str = "*", kind: str = "",
                                 object_id: str = "",
                                 force: bool = False) -> list[dict]:
        params = {}
        if kind:
            params["kind"] = kind
        if object_id:
            params["object-id"] = object_id
        if force:
            params["force"] = "true"
        resp = self.api_call(
            "DELETE", self._path(project or "*", "runtime-resources"),
            "delete runtime resources", params=params or None)
        return resp.get("deleted", [])

    def remote_builder(self, func, with_gpu: bool = False) -> dict:
        # the wire keeps the reference's flag name: the service reads it
        # as "build on the accelerator image"
        return self.api_call(
            "POST", "build/function", "remote build",
            json_body={"function": func.to_dict(), "with_tpu": with_gpu})

    def get_builder_status(self, func, offset=0, logs=True):
        # tag must travel: a function deployed as `mytag` keeps its build
        # status under that tag — omitting it made the server default to
        # `latest` and 404 polls on non-latest deploys (ADVICE r3/r4)
        return self.api_call(
            "GET", "build/status", "build status",
            params={"name": func.metadata.name,
                    "project": func.metadata.project, "offset": offset,
                    "tag": getattr(func.metadata, "tag", "") or "latest"})

    def get_background_task(self, name: str, project: str = ""):
        resp = self.api_call("GET",
                             self._path(project, "background-tasks", name),
                             "get background task")
        return resp.get("data")

    def trigger_migrations(self):
        return self.api_call("POST", "operations/migrations",
                             "trigger migrations")

    def get_log_size(self, uid, project=""):
        resp = self.api_call("GET",
                             self._path(project, "logs", uid) + "/size",
                             "get log size")
        return resp.get("size", 0)

    def verify_authorization(self, *args, **kwargs):
        return True
