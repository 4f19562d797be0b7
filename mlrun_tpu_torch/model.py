"""Core object model — the port's copy of ``mlrun_tpu/model.py``:
``ModelObj``, the dict round-trip base the graph's steps and
``GraphServer`` inherit, and the run objects (``RunMetadata``,
``RunSpec``, ``RunStatus``, ``RunTemplate``, ``RunObject``, ``new_task``)
with the specs they nest (``HyperParamOptions``, ``Notification``,
``ImageBuilder``). The fields are the reference's, so a spec or run dict
either package serializes loads in the other and serializes back to the
same dict."""

from __future__ import annotations

import base64
import json
import time
from copy import deepcopy
from typing import Any, Optional

from .common.runtimes_constants import RunStates

# the run-level retry policy's keys and defaults (the reference's
# common/schemas/run.RetryPolicy)
_RETRY_POLICY = {"max_retries": 0, "backoff": 5.0, "backoff_factor": 2.0,
                 "backoff_max": 300.0, "jitter": 0.1, "retry_on": None,
                 "stall_timeout": -1.0, "on_stall": "abort"}


def retry_policy(**fields) -> dict:
    """A validated retry-policy dict, None values dropped (the
    reference's ``RetryPolicy(...).model_dump(exclude_none=True)``)."""
    unknown = set(fields) - set(_RETRY_POLICY)
    if unknown:
        raise ValueError(f"unknown retry policy fields {sorted(unknown)}")
    policy = {**_RETRY_POLICY, **fields}
    floors = {"max_retries": 0, "backoff": 0, "backoff_factor": 1.0,
              "backoff_max": 0, "jitter": 0}
    for key, floor in floors.items():
        if policy[key] < floor:
            raise ValueError(f"retry policy {key} must be >= {floor}")
    if policy["jitter"] > 1.0:
        raise ValueError("retry policy jitter must be <= 1.0")
    if policy["on_stall"] not in ("abort", "resubmit"):
        raise ValueError("on_stall must be 'abort' or 'resubmit'")
    if policy["retry_on"] is not None:
        from .common.retry import FailureClass

        unknown = set(policy["retry_on"]) - set(FailureClass.retryable())
        if unknown:
            raise ValueError(
                f"unknown retry_on failure classes {sorted(unknown)}; "
                f"valid: {FailureClass.retryable()}")
    policy["max_retries"] = int(policy["max_retries"])
    for key in ("backoff", "backoff_factor", "backoff_max", "jitter",
                "stall_timeout"):
        policy[key] = float(policy[key])
    return {k: v for k, v in policy.items() if v is not None}


class ModelObj:
    """Dict-serializable base object.

    Subclasses list plain fields in ``_dict_fields`` and nested model
    fields in ``_nested_fields`` mapping name -> class (or None for a raw
    dict).
    """

    _dict_fields: list[str] = []
    _nested_fields: dict[str, type | None] = {}

    @staticmethod
    def _verify_list(param, name):
        if param is not None and not isinstance(param, list):
            raise ValueError(f"parameter {name} must be a list")

    @staticmethod
    def _verify_dict(param, name):
        if param is not None and not isinstance(param, dict):
            raise ValueError(f"parameter {name} must be a dict")

    def to_dict(self, exclude: list | None = None) -> dict:
        exclude = exclude or []
        out: dict[str, Any] = {}
        fields = self._dict_fields or [
            k for k in self.__dict__ if not k.startswith("_")
        ]
        for field in fields:
            if field in exclude:
                continue
            value = getattr(self, field, None)
            if value is None:
                continue
            if isinstance(value, ModelObj):
                value = value.to_dict()
            elif isinstance(value, list) and value \
                    and isinstance(value[0], ModelObj):
                value = [v.to_dict() for v in value]
            out[field] = value
        return out

    @classmethod
    def from_dict(cls, struct: dict | None = None,
                  deprecated_fields: dict | None = None):
        struct = struct or {}
        deprecated_fields = deprecated_fields or {}
        obj = cls()
        fields = cls._dict_fields or list(struct.keys())
        for field in fields:
            if field not in struct:
                continue
            value = struct[field]
            nested_cls = cls._nested_fields.get(field)
            if nested_cls is not None and isinstance(value, dict):
                value = nested_cls.from_dict(value)
            setattr(obj, field, value)
        for old, new in deprecated_fields.items():
            if old in struct and new:
                setattr(obj, new, struct[old])
        return obj

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), default=str)

    def to_yaml(self) -> str:
        import yaml

        return yaml.safe_dump(self.to_dict(), default_flow_style=False)

    def copy(self):
        return deepcopy(self)

    def __repr__(self):
        return f"{self.__class__.__name__}({self.to_dict()})"


class Credentials(ModelObj):
    _dict_fields = ["access_key"]

    def __init__(self, access_key: str | None = None):
        self.access_key = access_key


class ImageBuilder(ModelObj):
    """Image build spec."""

    _dict_fields = [
        "functionSourceCode", "source", "image", "base_image", "commands",
        "extra", "secret", "code_origin", "origin_filename", "requirements",
    ]

    def __init__(self, functionSourceCode=None, source=None, image=None,
                 base_image=None, commands=None, extra=None, secret=None,
                 code_origin=None, origin_filename=None, requirements=None):
        self.functionSourceCode = functionSourceCode
        self.source = source
        self.image = image
        self.base_image = base_image
        self.commands = commands or []
        self.extra = extra
        self.secret = secret
        self.code_origin = code_origin
        self.origin_filename = origin_filename
        self.requirements = requirements or []

    def with_source(self, source_code: str):
        self.functionSourceCode = base64.b64encode(source_code.encode()).decode()
        return self


class Notification(ModelObj):
    """Notification spec."""

    _dict_fields = [
        "kind", "name", "message", "severity", "when", "condition",
        "params", "status", "sent_time",
    ]

    def __init__(self, kind="console", name="", message="", severity="info",
                 when=None, condition="", params=None, status=None, sent_time=None):
        self.kind = kind
        self.name = name
        self.message = message
        self.severity = severity
        self.when = when or ["completed", "error"]
        self.condition = condition
        self.params = params or {}
        self.status = status
        self.sent_time = sent_time


class HyperParamStrategies:
    grid = "grid"
    list = "list"
    random = "random"
    custom = "custom"
    all = [grid, list, random, custom]


class HyperParamOptions(ModelObj):
    """Hyper-parameter sweep options."""

    _dict_fields = [
        "param_file", "strategy", "selector", "max_iterations", "max_errors",
        "parallel_runs", "stop_condition", "teardown_dask",
    ]

    def __init__(self, param_file=None, strategy=None, selector=None,
                 max_iterations=None, max_errors=None, parallel_runs=None,
                 stop_condition=None, teardown_dask=None):
        self.param_file = param_file
        self.strategy = strategy
        self.selector = selector  # e.g. "max.accuracy" / "min.loss"
        self.max_iterations = max_iterations
        self.max_errors = max_errors
        self.parallel_runs = parallel_runs
        self.stop_condition = stop_condition
        self.teardown_dask = teardown_dask


class RunMetadata(ModelObj):
    _dict_fields = ["uid", "name", "project", "labels", "annotations", "iteration"]

    def __init__(self, uid=None, name=None, project=None, labels=None,
                 annotations=None, iteration=None):
        self.uid = uid
        self.name = name
        self.project = project
        self.labels = labels or {}
        self.annotations = annotations or {}
        self.iteration = iteration or 0


class RunSpec(ModelObj):
    """Run spec."""

    _dict_fields = [
        "parameters", "hyperparams", "hyper_param_options", "inputs", "outputs",
        "input_path", "output_path", "function", "secret_sources", "data_stores",
        "handler", "scrape_metrics", "verbose", "notifications", "state_thresholds",
        "returns", "allow_empty_resources", "retry_policy",
    ]
    _nested_fields = {"hyper_param_options": HyperParamOptions}

    def __init__(self, parameters=None, hyperparams=None, hyper_param_options=None,
                 inputs=None, outputs=None, input_path=None, output_path=None,
                 function=None, secret_sources=None, data_stores=None, handler=None,
                 scrape_metrics=None, verbose=None, notifications=None,
                 state_thresholds=None, returns=None, allow_empty_resources=None,
                 retry_policy=None):
        self.parameters = parameters or {}
        self.hyperparams = hyperparams or {}
        self.hyper_param_options = hyper_param_options or HyperParamOptions()
        self.inputs = inputs or {}
        self.outputs = outputs or []
        self.input_path = input_path
        self.output_path = output_path
        self.function = function
        self.secret_sources = secret_sources or []
        self.data_stores = data_stores or []
        self.handler = handler
        self.scrape_metrics = scrape_metrics
        self.verbose = verbose
        self.notifications = notifications or []
        self.state_thresholds = state_thresholds or {}
        self.returns = returns or []
        self.allow_empty_resources = allow_empty_resources
        # run-level fault tolerance (common/schemas/run.py RetryPolicy;
        # enforced by service/runtime_handlers.py monitor_runs)
        self.retry_policy = retry_policy or {}

    @property
    def handler_name(self) -> str:
        if callable(self.handler):
            return self.handler.__name__
        return str(self.handler or "")

    def is_hyper_job(self) -> bool:
        return bool(self.hyperparams) or bool(
            self.hyper_param_options and self.hyper_param_options.param_file
        )


class RunStatus(ModelObj):
    """Run status."""

    _dict_fields = [
        "state", "error", "host", "commit", "status_text", "results", "artifacts",
        "artifact_uris", "start_time", "last_update", "end_time", "iterations",
        "ui_url", "reason", "notifications", "retry_count", "failure_class",
        "checkpoint", "last_heartbeat",
    ]

    def __init__(self, state=None, error=None, host=None, commit=None,
                 status_text=None, results=None, artifacts=None, artifact_uris=None,
                 start_time=None, last_update=None, end_time=None, iterations=None,
                 ui_url=None, reason=None, notifications=None, retry_count=None,
                 failure_class=None, checkpoint=None, last_heartbeat=None):
        self.state = state or RunStates.created
        self.error = error
        self.host = host
        self.commit = commit
        self.status_text = status_text
        self.results = results
        self.artifacts = artifacts
        self.artifact_uris = artifact_uris or {}
        self.start_time = start_time
        self.last_update = last_update
        self.end_time = end_time
        self.iterations = iterations
        self.ui_url = ui_url
        self.reason = reason
        self.notifications = notifications or {}
        # fault-tolerance bookkeeping (service monitor + in-run ctx)
        self.retry_count = retry_count
        self.failure_class = failure_class
        self.checkpoint = checkpoint
        self.last_heartbeat = last_heartbeat

    def is_failed(self) -> Optional[bool]:
        if self.state in RunStates.error_states():
            return True
        if self.state in RunStates.terminal_states():
            return False
        return None


class RunTemplate(ModelObj):
    """A submittable task: metadata + spec."""

    _dict_fields = ["kind", "metadata", "spec"]
    _nested_fields = {"metadata": RunMetadata, "spec": RunSpec}
    kind = "run"

    def __init__(self, spec: RunSpec | None = None, metadata: RunMetadata | None = None):
        self.spec = spec or RunSpec()
        self.metadata = metadata or RunMetadata()

    # fluent task-building api
    def with_params(self, **params):
        self.spec.parameters = params
        return self

    def with_input(self, key, path):
        self.spec.inputs[key] = path
        return self

    def with_hyper_params(self, hyperparams: dict, selector=None, strategy=None,
                          **options):
        self.spec.hyperparams = hyperparams
        opts = self.spec.hyper_param_options or HyperParamOptions()
        opts.selector = selector or opts.selector
        opts.strategy = strategy or opts.strategy
        for key, value in options.items():
            setattr(opts, key, value)
        self.spec.hyper_param_options = opts
        return self

    def with_secrets(self, kind, source):
        self.spec.secret_sources.append({"kind": kind, "source": source})
        return self

    def with_retry(self, max_retries: int = 3, backoff: float = 5.0,
                   backoff_factor: float = 2.0, backoff_max: float = 300.0,
                   jitter: float = 0.1, retry_on: list | None = None,
                   stall_timeout: float = -1.0, on_stall: str = "abort"):
        """Opt this run into service-side resubmission on infra failures
        (preemption, image-pull backoff, node drain, 5xx) — user-code
        errors are never retried. ``stall_timeout``/``on_stall`` arm the
        heartbeat watchdog."""
        self.spec.retry_policy = retry_policy(
            max_retries=max_retries, backoff=backoff,
            backoff_factor=backoff_factor, backoff_max=backoff_max,
            jitter=jitter, retry_on=retry_on, stall_timeout=stall_timeout,
            on_stall=on_stall)
        return self

    def set_label(self, key, value):
        self.metadata.labels[key] = str(value)
        return self


class RunObject(RunTemplate):
    """A submitted/executing run — template + live status."""

    _dict_fields = ["kind", "metadata", "spec", "status"]
    _nested_fields = {"metadata": RunMetadata, "spec": RunSpec, "status": RunStatus}

    def __init__(self, spec=None, metadata=None, status=None):
        super().__init__(spec, metadata)
        self.status = status or RunStatus()
        self._db = None

    @classmethod
    def from_template(cls, template: RunTemplate) -> "RunObject":
        return cls(spec=template.spec.copy(), metadata=template.metadata.copy())

    @property
    def uid(self) -> str:
        return self.metadata.uid

    def state(self) -> str:
        """Current run state — a METHOD: terminal states return directly, a
        non-terminal state refreshes from the DB first so pollers see
        live progress."""
        current = (self.status.state if self.status else None)
        if current in RunStates.terminal_states():
            return current
        try:
            self.refresh()
        except Exception:  # noqa: BLE001 - detached object (no DB): the
            # locally-known state is still the best answer
            pass
        return (self.status.state if self.status else None) \
            or RunStates.created

    @property
    def error(self) -> str:
        """Error string when the run failed/aborted, else ''
       ."""
        if self.status and self.status.state in (
                RunStates.error, RunStates.aborted, RunStates.aborting):
            return (self.status.error or self.status.reason
                    or self.status.status_text
                    or ("run was aborted"
                        if self.status.state != RunStates.error
                        else "unknown error"))
        return ""

    @property
    def ui_url(self) -> str:
        """UI URL when a frontend is attached."""
        return (self.status.ui_url if self.status else "") or ""

    def abort(self):
        """Abort the run server-side."""
        self._run_db().abort_run(self.metadata.uid, self.metadata.project)

    @staticmethod
    def create_uri(project: str, uid: str, iteration, tag: str = "") -> str:
        """<project>@<uid>#<iteration>[:tag]."""
        suffix = f":{tag}" if tag else ""
        return f"{project}@{uid}#{iteration}{suffix}"

    @staticmethod
    def parse_uri(uri: str) -> tuple:
        """Parse <project>@<uid>#<iteration>[:tag] back to its parts
       ."""
        import re

        match = re.match(
            r"^(?P<project>[^@]+)@(?P<uid>[^#]+)#(?P<iteration>[^:]+)"
            r"(:(?P<tag>.+))?$", uri)
        if not match:
            raise ValueError(
                "uri not in supported format "
                "<project>@<uid>#<iteration>[:tag]")
        groups = match.groupdict()
        return (groups["project"], groups["uid"], groups["iteration"],
                groups["tag"] or "")

    def output(self, key: str):
        """Return a result value or artifact uri by key."""
        if self.status.results and key in self.status.results:
            return self.status.results[key]
        return (self.status.artifact_uris or {}).get(key)

    @property
    def outputs(self) -> dict:
        out = dict(self.status.results or {})
        out.update(self.status.artifact_uris or {})
        return out

    def artifact(self, key: str):
        """Return a DataItem for a named output artifact."""
        uri = (self.status.artifact_uris or {}).get(key)
        if not uri:
            return None
        from .datastore import store_manager

        return store_manager.object(url=uri)

    def _run_db(self):
        if self._db is None:
            from .db import get_run_db

            self._db = get_run_db()
        return self._db

    def refresh(self) -> "RunObject":
        db = self._run_db()
        updated = db.read_run(
            uid=self.metadata.uid, project=self.metadata.project,
            iter=self.metadata.iteration,
        )
        if updated:
            self.status = RunStatus.from_dict(updated.get("status", {}))
        return self

    def logs(self, watch: bool = True, db=None, offset: int = 0) -> str:
        """Fetch (and optionally tail) run logs."""
        db = db or self._run_db()
        state, text = db.watch_log(
            self.metadata.uid, self.metadata.project, watch=watch, offset=offset
        )
        if state:
            self.status.state = state
        return state

    def wait_for_completion(self, sleep: float = 1.0, timeout: float = 600,
                            raise_on_failure: bool = True) -> str:
        """Poll the DB until the run reaches a terminal state (model.py:1767)."""
        start = time.monotonic()
        while True:
            self.refresh()
            if self.status.state in RunStates.terminal_states():
                break
            if time.monotonic() - start > timeout:
                raise TimeoutError(
                    f"run {self.metadata.uid} did not complete within {timeout}s"
                )
            time.sleep(sleep)
        if raise_on_failure and self.status.state != RunStates.completed:
            raise RuntimeError(
                f"task {self.metadata.name} did not complete "
                f"(state={self.status.state})"
            )
        return self.status.state

    def show(self):
        """Notebook-rich run view (render.py's detail card); a log summary
        outside IPython."""
        from .render import run_to_html
        from .utils import logger

        html = run_to_html(self.to_dict(), display=True)
        if not html:
            logger.info(
                "run summary", name=self.metadata.name,
                uid=self.metadata.uid, state=self.status.state,
                results=self.status.results,
                artifacts=list((self.status.artifact_uris or {}).keys()),
            )

    def _repr_html_(self) -> str:
        from .render import run_to_html

        return run_to_html(self.to_dict(), display=False)

    def to_dict(self, exclude=None):
        out = super().to_dict(exclude)
        out["kind"] = self.kind
        return out


def new_task(name: str = "", project: str = "", handler=None, params: dict | None = None,
             hyper_params: dict | None = None, param_file: str = "", selector: str = "",
             hyper_param_options: HyperParamOptions | dict | None = None,
             inputs: dict | None = None, outputs: list | None = None,
             in_path: str = "", out_path: str = "", artifact_path: str = "",
             secrets: list | None = None, base: RunTemplate | None = None,
             returns: list | None = None) -> RunTemplate:
    """Create a RunTemplate."""
    if base:
        run = deepcopy(base)
    else:
        run = RunTemplate()
    run.metadata.name = name or run.metadata.name
    run.metadata.project = project or run.metadata.project
    spec = run.spec
    spec.handler = handler or spec.handler
    spec.parameters = params or spec.parameters
    spec.hyperparams = hyper_params or spec.hyperparams
    if isinstance(hyper_param_options, dict):
        hyper_param_options = HyperParamOptions.from_dict(hyper_param_options)
    spec.hyper_param_options = hyper_param_options or spec.hyper_param_options
    if param_file:
        spec.hyper_param_options.param_file = param_file
    if selector:
        spec.hyper_param_options.selector = selector
    spec.inputs = inputs or spec.inputs
    spec.outputs = outputs or spec.outputs
    spec.returns = returns or spec.returns
    spec.input_path = in_path or spec.input_path
    spec.output_path = artifact_path or out_path or spec.output_path
    spec.secret_sources = secrets or spec.secret_sources
    return run


NewTask = new_task


class RunOutputs:
    """Convenience dict-like view on run outputs used by pipelines."""

    def __init__(self, run: RunObject):
        self._run = run

    def __getitem__(self, key):
        value = self._run.output(key)
        if value is None:
            raise KeyError(key)
        return value

    def keys(self):
        return self._run.outputs.keys()
