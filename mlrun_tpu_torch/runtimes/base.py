"""Runtime base — the port's copy of ``mlrun_tpu/runtimes/base.py``
(``BaseRuntime``, ``FunctionSpec``; ``run()`` delegates to a launcher)."""

from __future__ import annotations

import os
from typing import Callable, Optional, Union

from ..config import run_config
from ..model import ImageBuilder, ModelObj, Notification, RunObject, RunTemplate
from ..utils.helpers import normalize_name, now_iso
from ..utils.logger import logger


class FunctionMetadata(ModelObj):
    _dict_fields = ["name", "tag", "hash", "project", "labels", "annotations",
                    "categories", "updated", "credentials"]

    def __init__(self, name=None, tag=None, hash=None, project=None, labels=None,
                 annotations=None, categories=None, updated=None, credentials=None):
        self.name = name
        self.tag = tag
        self.hash = hash
        self.project = project
        self.labels = labels or {}
        self.annotations = annotations or {}
        self.categories = categories or []
        self.updated = updated
        self.credentials = credentials


class FunctionSpec(ModelObj):
    _dict_fields = [
        "command", "args", "image", "mode", "build", "entry_points",
        "description", "workdir", "default_handler", "pythonpath", "env",
        "resources", "replicas", "image_pull_policy", "service_account",
        "node_selector", "priority_class_name", "preemption_mode",
        "state_thresholds",
    ]
    _nested_fields = {"build": ImageBuilder}

    def __init__(self, command=None, args=None, image=None, mode=None, build=None,
                 entry_points=None, description=None, workdir=None,
                 default_handler=None, pythonpath=None, env=None, resources=None,
                 replicas=None, image_pull_policy=None, service_account=None,
                 node_selector=None, priority_class_name=None,
                 preemption_mode=None, state_thresholds=None):
        self.command = command or ""
        self.args = args or []
        self.image = image or ""
        self.mode = mode
        self.build = build or ImageBuilder()
        self.entry_points = entry_points or {}
        self.description = description or ""
        self.workdir = workdir
        self.default_handler = default_handler
        self.pythonpath = pythonpath
        self.env = env or []
        self.resources = resources or {}
        self.replicas = replicas
        self.image_pull_policy = image_pull_policy
        self.service_account = service_account
        self.node_selector = node_selector or {}
        self.priority_class_name = priority_class_name
        self.preemption_mode = preemption_mode
        self.state_thresholds = state_thresholds or {}


class FunctionStatus(ModelObj):
    _dict_fields = ["state", "build_pod", "external_invocation_urls", "address",
                    "nodes"]

    def __init__(self, state=None, build_pod=None, external_invocation_urls=None,
                 address=None, nodes=None):
        self.state = state
        self.build_pod = build_pod
        self.external_invocation_urls = external_invocation_urls or []
        self.address = address
        self.nodes = nodes


class BaseRuntime(ModelObj):
    kind = "base"
    _is_nested = False
    _is_remote = False
    _dict_fields = ["kind", "metadata", "spec", "status"]
    _nested_fields = {"metadata": FunctionMetadata, "spec": FunctionSpec,
                      "status": FunctionStatus}

    def __init__(self, metadata=None, spec=None, status=None):
        self.metadata = metadata or FunctionMetadata()
        self.spec = spec or FunctionSpec()
        self.status = status or FunctionStatus()
        self._db = None
        self._handler: Optional[Callable] = None  # in-process handler (local)
        self.verbose = False
        self._enriched = False

    # -- spec helpers ------------------------------------------------------
    @property
    def uri(self) -> str:
        project = self.metadata.project or run_config("default_project")
        uri = f"{project}/{self.metadata.name}"
        if self.metadata.tag:
            uri += f":{self.metadata.tag}"
        if self.metadata.hash:
            uri += f"@{self.metadata.hash}"
        return uri

    @property
    def is_deployed(self) -> bool:
        return True

    def is_remote(self) -> bool:
        return self._is_remote

    def with_code(self, from_file: str = "", body: str | None = None):
        if from_file:
            with open(from_file) as fp:
                body = fp.read()
        if body:
            self.spec.build.with_source(body)
            self.spec.build.origin_filename = from_file
        return self

    def with_commands(self, commands: list[str],
                      overwrite: bool = False) -> "BaseRuntime":
        """Add image-build shell commands (the service's image build runs
        them)."""
        current = [] if overwrite else list(self.spec.build.commands or [])
        self.spec.build.commands = current + [
            c for c in commands if c not in current]
        return self

    def requires_build(self) -> bool:
        """True when deploy must run an actual build."""
        build = self.spec.build
        return bool(build.commands or build.requirements
                    or build.source or build.extra)

    def set_db_connection(self, db):
        """Pin the run DB this function talks to."""
        self._db = db

    def store_run(self, runobj: "RunObject"):
        """Persist a run object through the function's DB."""
        self._get_db().store_run(
            runobj.to_dict(), runobj.metadata.uid,
            runobj.metadata.project or run_config("default_project"))

    def prepare_image_for_deploy(self):
        """Resolve the image a deploy will use: an explicit image wins;
        a build spec keeps its target; otherwise the configured default."""
        if self.spec.image:
            return
        if self.spec.build.image:
            self.spec.image = self.spec.build.image
        elif not self.requires_build():
            self.spec.image = run_config("default_image")

    def clean_build_params(self) -> "BaseRuntime":
        """Drop credentials from the build spec before export/share."""
        self.spec.build.secret = None
        return self

    def with_requirements(self, requirements: list[str]):
        self.spec.build.requirements = list(requirements)
        return self

    def set_env(self, name: str, value) -> "BaseRuntime":
        for item in self.spec.env:
            if item.get("name") == name:
                item["value"] = str(value)
                return self
        self.spec.env.append({"name": name, "value": str(value)})
        return self

    def get_env(self, name: str, default=None):
        for item in self.spec.env:
            if item.get("name") == name:
                return item.get("value")
        return default

    def set_envs(self, env_vars: dict):
        for key, value in env_vars.items():
            self.set_env(key, value)
        return self

    def set_label(self, key, value):
        self.metadata.labels[key] = str(value)
        return self

    def _get_db(self):
        if self._db is None:
            from ..db import get_run_db

            self._db = get_run_db()
        return self._db

    def save(self, tag: str = "", versioned: bool = True) -> str:
        db = self._get_db()
        tag = tag or self.metadata.tag or "latest"
        self.metadata.tag = tag
        self.metadata.updated = now_iso()
        hash_key = db.store_function(
            self.to_dict(), self.metadata.name,
            self.metadata.project or run_config("default_project"),
            tag=tag, versioned=versioned)
        self.metadata.hash = hash_key
        return f"db://{self.uri}"

    def export(self, target: str = "", format: str = "yaml") -> "BaseRuntime":
        target = target or f"function-{self.metadata.name}.yaml"
        body = self.to_yaml() if format == "yaml" else self.to_json()
        from ..datastore import store_manager

        store, path = store_manager.get_or_create_store(target)
        store.put(path, body)
        logger.info("function exported", target=target)
        return self

    # -- run ---------------------------------------------------------------
    def run(self, runspec: Union[RunTemplate, RunObject, dict, None] = None,
            handler: Union[str, Callable, None] = None, name: str = "",
            project: str = "", params: dict | None = None,
            inputs: dict | None = None, out_path: str = "",
            artifact_path: str = "", workdir: str = "", watch: bool = True,
            schedule: str | None = None, hyperparams: dict | None = None,
            hyper_param_options=None, verbose: bool | None = None,
            scrape_metrics: bool | None = None, local: bool = False,
            local_code_path: str | None = None, auto_build: bool = False,
            returns: list | None = None, notifications: list | None = None,
            state_thresholds: dict | None = None, **launcher_kwargs) -> RunObject:
        """Run this function — in this process with ``local=True`` (or for
        the local kinds); a cluster kind without it needs the service."""
        from ..launcher.factory import LauncherFactory

        if isinstance(runspec, dict):
            runspec = RunTemplate.from_dict(runspec)
        run = self._create_run_object(runspec)
        if handler is not None:
            run.spec.handler = handler
        run.metadata.name = name or run.metadata.name or self.metadata.name \
            or (handler.__name__ if callable(handler) else "run")
        run.metadata.name = normalize_name(run.metadata.name)
        run.metadata.project = (
            project or run.metadata.project or self.metadata.project
            or run_config("default_project"))
        if params:
            run.spec.parameters = {**(run.spec.parameters or {}), **params}
        if inputs:
            run.spec.inputs = {**(run.spec.inputs or {}), **inputs}
        if hyperparams:
            run.spec.hyperparams = hyperparams
        if hyper_param_options:
            if isinstance(hyper_param_options, dict):
                from ..model import HyperParamOptions

                hyper_param_options = HyperParamOptions.from_dict(
                    hyper_param_options)
            run.spec.hyper_param_options = hyper_param_options
        if returns:
            run.spec.returns = returns
        if notifications:
            run.spec.notifications = [
                n.to_dict() if isinstance(n, Notification) else n
                for n in notifications
            ]
        if state_thresholds:
            run.spec.state_thresholds = state_thresholds
        run.spec.output_path = (
            artifact_path or out_path or run.spec.output_path)
        if workdir:
            self.spec.workdir = workdir
        if verbose is not None:
            self.verbose = verbose
        run.spec.scrape_metrics = (
            scrape_metrics if scrape_metrics is not None
            else run.spec.scrape_metrics)

        launcher = LauncherFactory.create_launcher(
            is_remote=self.is_remote() and not local, local=local)
        return launcher.launch(
            runtime=self, task=run, schedule=schedule, watch=watch,
            auto_build=auto_build, **launcher_kwargs)

    def _create_run_object(self, runspec) -> RunObject:
        if runspec is None:
            return RunObject()
        if isinstance(runspec, RunObject):
            return runspec
        if isinstance(runspec, RunTemplate):
            return RunObject.from_template(runspec)
        raise ValueError(f"unsupported runspec type {type(runspec)}")

    # executed server-side (or in-process for local kinds) by the launcher
    def _run(self, runobj: RunObject, execution) -> dict:
        raise NotImplementedError(
            f"runtime kind '{self.kind}' executes remotely; "
            "submit via the service")

    def _pre_run(self, runobj: RunObject, execution):
        pass

    def _post_run(self, results: dict, execution):
        pass

    # -- pipelines ---------------------------------------------------------
    def as_step(self, runspec: RunTemplate | None = None, handler=None,
                name: str = "", project: str = "", params: dict | None = None,
                inputs: dict | None = None, outputs: list | None = None,
                artifact_path: str = "", image: str = "", **kwargs):
        """A workflow step (the projects' pipeline engine, item 13)."""
        from ..serving.resilience import not_ported

        raise not_ported("workflow steps (projects/pipelines.py)", 13)

    def doc(self):
        entry_points = self.spec.entry_points or {}
        print(f"function: {self.metadata.name}")
        print(self.spec.description or "")
        for name, ep in entry_points.items():
            print(f"  handler {name}: {ep.get('doc', '')}")
            for param in ep.get("parameters", []):
                print(f"    {param.get('name')} ({param.get('type', '')})")

    def full_image_path(self, image: str | None = None) -> str:
        return image or self.spec.image or run_config("default_image")
