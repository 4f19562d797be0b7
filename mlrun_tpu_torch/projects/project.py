"""Projects — the port's copy of ``mlrun_tpu/projects/project.py``:
``MlrunProject`` with its functions, params, secrets, artifacts, datastore
profiles, alert configs, model-monitoring params and workflows, its
``project.yaml`` and git remotes, and ``new_project`` / ``load_project``
/ ``get_or_create_project`` / ``get_current_project``. Building images and
deploying serving functions go through the service (its builder and its
deployment manager)."""

from __future__ import annotations

import os
import shutil
import subprocess
import typing

import yaml

from ..artifacts import ArtifactManager, ArtifactProducer
from ..config import resolve_artifact_path
from ..model import ModelObj
from ..utils.helpers import generate_uid, normalize_name, now_iso
from ..utils.logger import logger
from .pipelines import (
    _PipelineRunStatus,
    get_workflow_engine,
    pipeline_context,
)

_current_project = None


class ProjectMetadata(ModelObj):
    _dict_fields = ["name", "created", "labels", "annotations"]

    def __init__(self, name=None, created=None, labels=None, annotations=None):
        self.name = name
        self.created = created
        self.labels = labels or {}
        self.annotations = annotations or {}


class ProjectSpec(ModelObj):
    _dict_fields = [
        "description", "params", "functions", "workflows", "artifacts",
        "source", "context", "subpath", "origin_url", "goals", "owner",
        "artifact_path", "conda", "default_image", "build",
        "default_requirements",
    ]

    def __init__(self, description=None, params=None, functions=None,
                 workflows=None, artifacts=None, source=None, context=None,
                 subpath=None, origin_url=None, goals=None, owner=None,
                 artifact_path=None, conda=None, default_image=None,
                 build=None, default_requirements=None):
        self.description = description
        self.params = params or {}
        self.functions = functions or []   # [{name, spec|url, kind, image...}]
        self.workflows = workflows or []   # [{name, path, handler, engine}]
        self.artifacts = artifacts or []
        self.source = source
        self.context = context or "./"
        self.subpath = subpath
        self.origin_url = origin_url
        self.goals = goals
        self.owner = owner
        self.artifact_path = artifact_path
        self.conda = conda
        self.default_image = default_image
        self.build = build
        self.default_requirements = default_requirements or []

    def get_workflow(self, name: str) -> dict | None:
        for workflow in self.workflows:
            if workflow.get("name") == name:
                return workflow
        return None

    def set_workflow(self, name: str, workflow: dict):
        self.workflows = [w for w in self.workflows
                          if w.get("name") != name] + [workflow]


class ProjectStatus(ModelObj):
    _dict_fields = ["state"]

    def __init__(self, state=None):
        self.state = state


class MlrunProject(ModelObj):
    kind = "project"
    _dict_fields = ["kind", "metadata", "spec", "status"]
    _nested_fields = {"metadata": ProjectMetadata, "spec": ProjectSpec,
                      "status": ProjectStatus}

    def __init__(self, metadata=None, spec=None, status=None):
        self.metadata = metadata or ProjectMetadata()
        self.spec = spec or ProjectSpec()
        self.status = status or ProjectStatus()
        self._function_objects: dict[str, typing.Any] = {}
        self._db = None
        self._artifact_manager = None

    # -- identity ----------------------------------------------------------
    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def artifact_path(self) -> str:
        return self.spec.artifact_path or resolve_artifact_path(self.name)

    def _get_db(self):
        if self._db is None:
            from ..db import get_run_db

            self._db = get_run_db()
        return self._db

    def get_param(self, key: str, default=None):
        return self.spec.params.get(key, default)

    # -- functions ---------------------------------------------------------
    def set_function(self, func=None, name: str = "", kind: str = "",
                     image: str = "", handler: str = "", with_repo=None,
                     tag: str = "", requirements: list | None = None):
        """Register a function in the project. ``func`` may be a runtime object, a file path, or a
        db:// / hub:// url."""
        from ..run import code_to_function, import_function, new_function
        from ..runtimes.base import BaseRuntime

        if isinstance(func, BaseRuntime):
            function = func
            name = name or function.metadata.name
        elif isinstance(func, str) and (
                func.startswith("db://") or func.startswith("hub://")
                or func.endswith(".yaml")):
            function = import_function(func, project=self.name)
            name = name or function.metadata.name
        elif isinstance(func, str) and func.endswith(".py"):
            path = func if os.path.isabs(func) else os.path.join(
                self.spec.context or "./", func)
            function = code_to_function(
                name=name or os.path.splitext(os.path.basename(func))[0],
                project=self.name, filename=path, handler=handler,
                kind=kind or "job", image=image,
                requirements=requirements)
        elif func is None and handler:
            function = new_function(name=name or handler, kind=kind or "local",
                                    project=self.name)
            function.spec.default_handler = handler
        else:
            raise ValueError(f"unsupported function source {func!r}")
        function.metadata.project = self.name
        function.metadata.name = normalize_name(name or
                                                function.metadata.name)
        if image:
            function.spec.image = image
        if kind and function.kind != kind:
            pass  # kind conversion is explicit via to_job etc.
        if tag:
            function.metadata.tag = tag
        self._function_objects[function.metadata.name] = function
        entry = {"name": function.metadata.name, "kind": function.kind}
        self.spec.functions = [
            f for f in self.spec.functions
            if f.get("name") != function.metadata.name
        ] + [entry]
        return function

    def get_function(self, key: str, sync: bool = False, enrich: bool = False,
                     ignore_cache: bool = False):
        if key in self._function_objects and not ignore_cache:
            return self._function_objects[key]
        from ..run import import_function

        function = import_function(f"db://{self.name}/{key}")
        self._function_objects[key] = function
        return function

    def get_function_names(self) -> list[str]:
        return [f.get("name") for f in self.spec.functions]

    def remove_function(self, name: str):
        self._function_objects.pop(name, None)
        self.spec.functions = [f for f in self.spec.functions
                               if f.get("name") != name]

    def sync_functions(self, names: list | None = None, always: bool = True,
                       save: bool = False):
        for entry in self.spec.functions:
            name = entry.get("name")
            if names and name not in names:
                continue
            if name not in self._function_objects or always:
                try:
                    self.get_function(name, ignore_cache=True)
                except Exception as exc:  # noqa: BLE001
                    logger.warning("could not sync function", name=name,
                                   error=str(exc))
        if save:
            self.save()
        return self._function_objects

    # -- run / build / deploy ---------------------------------------------
    def run_function(self, function, handler: str = "", name: str = "",
                     params: dict | None = None, hyperparams: dict | None = None,
                     hyper_param_options=None, inputs: dict | None = None,
                     outputs: list | None = None, workdir: str = "",
                     labels: dict | None = None, base_task=None, watch=True,
                     local: bool | None = None, schedule=None,
                     artifact_path: str = "", notifications=None,
                     returns: list | None = None, builder_env=None):
        """Run a registered or given function."""
        function = self._resolve_function(function)
        context = pipeline_context()
        if context is not None:
            # inside a workflow file: create a step and run via the engine
            step = function.as_step(
                runspec=base_task, handler=handler, name=name,
                project=self.name, params=params, inputs=inputs,
                outputs=outputs, artifact_path=artifact_path,
                hyperparams=hyperparams,
                hyper_param_options=hyper_param_options, returns=returns)
            engine = getattr(context, "engine", "local")
            if engine == "kfp":
                # kfp tracing: emit a container op, do NOT execute
                from .pipelines import _KFPRunner

                return _KFPRunner._step_to_container_op(
                    step, context.artifact_path)
            if engine == "kfp-compile":
                # kfp-free IR compilation: record, do NOT execute
                context.steps.append(step)
                return step
            run = step.run(context)
            context.runs.append(run)
            return step
        run = function.run(
            base_task, handler=handler, name=name, params=params,
            hyperparams=hyperparams, hyper_param_options=hyper_param_options,
            inputs=inputs, artifact_path=artifact_path or self.artifact_path,
            watch=watch, schedule=schedule, notifications=notifications,
            returns=returns,
            # a run without local= runs here (the reference sends it to
            # the service whenever a dbpath is set); local=False submits
            local=True if local is None else local)
        return run

    def build_function(self, function, with_gpu: bool = False,
                       skip_deployed: bool = False, **kwargs):
        function = self._resolve_function(function)
        if hasattr(function, "deploy"):
            function.deploy(skip_deployed=skip_deployed, with_gpu=with_gpu)
        return function

    def deploy_function(self, function, models: list | None = None,
                        env: dict | None = None, tag: str = "", **kwargs):
        function = self._resolve_function(function)
        if env:
            function.set_envs(env)
        if models:
            for model in models:
                function.add_model(**model)
        address = function.deploy(project=self.name, tag=tag)
        return function, address

    def _resolve_function(self, function):
        from ..runtimes.base import BaseRuntime

        if isinstance(function, BaseRuntime):
            return function
        if isinstance(function, str):
            return self.get_function(function)
        raise ValueError(f"unsupported function arg {function!r}")

    # -- artifacts ---------------------------------------------------------
    def _producer(self) -> ArtifactProducer:
        return ArtifactProducer("project", self.name, self.name,
                                uid=generate_uid())

    def _get_artifact_manager(self) -> ArtifactManager:
        if self._artifact_manager is None:
            self._artifact_manager = ArtifactManager(db=self._get_db())
        return self._artifact_manager

    def log_artifact(self, item, body=None, tag: str = "", local_path: str = "",
                     artifact_path: str = "", format: str | None = None,
                     upload: bool | None = None, labels: dict | None = None,
                     target_path: str = "", **kwargs):
        manager = self._get_artifact_manager()
        artifact = manager.log_artifact(
            self._producer(), item, body=body, tag=tag, local_path=local_path,
            artifact_path=artifact_path or self.artifact_path, format=format,
            upload=upload, labels=labels, target_path=target_path, **kwargs)
        return artifact

    def log_dataset(self, key, df, tag="", local_path="", artifact_path="",
                    upload=None, labels=None, format="parquet", preview=None,
                    stats=None, target_path="", **kwargs):
        from ..artifacts import DatasetArtifact

        ds = DatasetArtifact(key, df=df, preview=preview, format=format,
                             stats=stats, target_path=target_path)
        return self.log_artifact(
            ds, tag=tag, local_path=local_path,
            artifact_path=artifact_path or self.artifact_path,
            upload=upload, labels=labels, **kwargs)

    def log_model(self, key, body=None, framework="", tag="", model_dir="",
                  model_file="", metrics=None, parameters=None,
                  artifact_path="", upload=None, labels=None, inputs=None,
                  outputs=None, extra_data=None, algorithm="", **kwargs):
        from ..artifacts import ModelArtifact

        model = ModelArtifact(
            key, body=body, model_file=model_file, model_dir=model_dir,
            metrics=metrics, parameters=parameters, inputs=inputs,
            outputs=outputs, framework=framework, algorithm=algorithm,
            extra_data=extra_data)
        return self.log_artifact(
            model, tag=tag, artifact_path=artifact_path or self.artifact_path,
            upload=upload, labels=labels, **kwargs)

    def get_artifact(self, key: str, tag: str = "", iter: int | None = None):
        db = self._get_db()
        struct = db.read_artifact(key, tag=tag or "latest", iter=iter,
                                  project=self.name)
        from ..artifacts import dict_to_artifact

        return dict_to_artifact(struct)

    def list_artifacts(self, name="", tag=None, labels=None, kind=None):
        return self._get_db().list_artifacts(
            name=name, project=self.name, tag=tag, labels=labels, kind=kind)

    def list_runs(self, name="", uid=None, labels=None, state="", last=0):
        return self._get_db().list_runs(
            name=name, uid=uid, project=self.name, labels=labels,
            state=state, last=last)

    def list_functions(self, name="", tag="", labels=None):
        return self._get_db().list_functions(
            name=name, project=self.name, tag=tag, labels=labels)

    def list_models(self, name="", tag=None, labels=None):
        return self._get_db().list_artifacts(
            name=name, project=self.name, tag=tag, labels=labels,
            kind="model")

    # -- source ------------------------------------------------------------
    def set_source(self, source: str = "", pull_at_runtime: bool = False,
                   workdir: str = ""):
        self.spec.source = source
        if workdir:
            self.spec.subpath = workdir
        return self

    def set_secrets(self, secrets: dict | None = None, file_path: str = ""):
        """Store project secrets (local mode: env process-level)."""
        import os as _os

        secrets = dict(secrets or {})
        if file_path:
            with open(file_path) as fp:
                for line in fp:
                    line = line.strip()
                    if line and not line.startswith("#") and "=" in line:
                        key, value = line.split("=", 1)
                        secrets[key.strip()] = value.strip()
        for key, value in secrets.items():
            _os.environ[f"MLT_SECRET_{key}"] = str(value)
        return self

    def get_secret(self, key: str, default=None):
        import os as _os

        return _os.environ.get(f"MLT_SECRET_{key}",
                               _os.environ.get(key, default))

    # -- workflows ---------------------------------------------------------
    def set_workflow(self, name: str, workflow_path: str, handler: str = "",
                     engine: str = "", **kwargs):
        self.spec.set_workflow(name, {
            "name": name, "path": workflow_path, "handler": handler,
            "engine": engine, **kwargs})
        return self

    def run(self, name: str = "", workflow_path: str = "",
            arguments: dict | None = None, artifact_path: str = "",
            workflow_handler=None, namespace=None, sync: bool = False,
            watch: bool = False, dirty: bool = False, engine: str = "",
            local: bool | None = None, schedule=None,
            timeout: float | None = None) -> _PipelineRunStatus:
        """Run a named or ad-hoc workflow."""
        workflow = None
        if name:
            workflow = self.spec.get_workflow(name)
            if workflow is None and not workflow_path and not workflow_handler:
                raise ValueError(f"workflow '{name}' is not defined")
        workflow = dict(workflow or {})
        if workflow_path:
            workflow["path"] = workflow_path
        engine = engine or workflow.get("engine") or "local"
        if local is None:
            local = engine == "local"
        if sync:
            self.sync_functions()
        runner = get_workflow_engine(engine, local=local)
        status = runner.run(
            self, workflow, name=name, workflow_handler=workflow_handler,
            artifact_path=artifact_path or self.artifact_path,
            args=arguments, local=local, watch=watch)
        if watch and engine != "local":
            status.wait_for_completion(timeout=timeout or 3600)
        return status

    # -- persistence -------------------------------------------------------
    # -- spec / metadata bridges ----------------------------------------
    # spec/metadata bridges: ported user code reads these directly off the
    # project object
    @property
    def description(self) -> str:
        return self.spec.description or ""

    @description.setter
    def description(self, value: str):
        self.spec.description = value

    @property
    def params(self) -> dict:
        return self.spec.params

    @params.setter
    def params(self, value: dict):
        self.spec.params = value or {}

    @property
    def source(self) -> str:
        return self.spec.source or ""

    @source.setter
    def source(self, value: str):
        self.spec.source = value

    @property
    def context(self) -> str:
        return self.spec.context or "./"

    @property
    def mountdir(self) -> str:
        return getattr(self.spec, "mountdir", "") or ""

    @property
    def workflows(self) -> list:
        return self.spec.workflows

    @property
    def artifacts(self) -> list:
        return self.spec.artifacts

    @property
    def default_image(self) -> str:
        return self.spec.default_image or ""

    def set_default_image(self, image: str):
        self.spec.default_image = image

    @property
    def notifiers(self):
        from ..utils.notifications import NotificationPusher

        return NotificationPusher([])

    def with_secrets(self, kind: str = "env", source=None) -> "MlrunProject":
        """Secrets from an env-file path or a dict of values."""
        if isinstance(source, dict):
            self.set_secrets(source)
        elif isinstance(source, str):
            self.set_secrets(file_path=source)
        return self

    # build
    def build_config(self, image: str = "", set_as_default: bool = False,
                     base_image: str = "", commands: list | None = None,
                     requirements: list | None = None, **kwargs):
        """Record the project-level build spec."""
        from ..model import ImageBuilder

        build = self.spec.build or ImageBuilder()
        if isinstance(build, dict):
            build = ImageBuilder.from_dict(build)
        build.image = image or build.image
        build.base_image = base_image or build.base_image
        if commands:
            build.commands = list(build.commands or []) + [
                c for c in commands if c not in (build.commands or [])]
        if requirements:
            build.requirements = list(build.requirements or []) + [
                q for q in requirements
                if q not in (build.requirements or [])]
        self.spec.build = build
        if set_as_default and image:
            self.set_default_image(image)
        return build

    def build_image(self, image: str = "", base_image: str = "",
                    commands: list | None = None,
                    requirements: list | None = None,
                    set_as_default: bool = True, with_gpu: bool = False):
        """Build the project image from the recorded and passed build
        config through the service's builder."""
        from ..run import new_function

        build = self.build_config(image=image, base_image=base_image,
                                  commands=commands,
                                  requirements=requirements)
        fn = new_function(f"{self.name}-image", project=self.name,
                          kind="job", image=build.image or "")
        fn.spec.build = build
        deployed = fn.deploy(watch=True, with_gpu=with_gpu)
        if deployed and set_as_default and fn.spec.image:
            self.set_default_image(fn.spec.image)
        return deployed

    # artifacts / store
    def get_artifact_uri(self, key: str, category: str = "artifact",
                         tag: str = "", iter: int | None = None) -> str:
        """store://<category>s/<project>/<key>[:tag]."""
        uri = f"store://{category}s/{self.name}/{key}"
        if iter is not None:
            uri = f"{uri}#{iter}"
        if tag:
            uri = f"{uri}:{tag}"
        return uri

    def get_store_resource(self, uri: str):
        from ..datastore import store_manager

        return store_manager.object(url=uri, project=self.name)

    def get_item_absolute_path(self, url: str) -> str:
        """Resolve a context-relative path against the project
        context."""
        if "://" in url or os.path.isabs(url):
            return url
        return os.path.join(self.spec.context or "./",
                            self.spec.subpath or "", url)

    def set_artifact(self, key: str, artifact=None, target_path: str = "",
                     tag: str = ""):
        """Register an artifact in the project spec (imported on
        load)."""
        entry = {"key": key, "target_path": target_path, "tag": tag}
        if isinstance(artifact, dict):
            entry.update(artifact)
        elif artifact is not None:
            entry.update(getattr(artifact, "to_dict", lambda: {})())
        self.spec.artifacts = [a for a in self.spec.artifacts
                               if a.get("key") != key] + [entry]

    def import_artifact(self, item_path: str, new_key: str = ""):
        """Load an exported artifact spec (yaml/json) and log it under
        this project."""
        from ..artifacts.manager import dict_to_artifact

        with open(item_path) as f:
            struct = yaml.safe_load(f)
        artifact = dict_to_artifact(struct)
        if new_key:
            artifact.metadata.key = new_key
        return self.log_artifact(artifact)

    def delete_artifact(self, key: str, tag: str = ""):
        self._get_db().del_artifact(key, tag=tag, project=self.name)

    # datastore profiles
    def register_datastore_profile(self, profile,
                                   private: dict | None = None):
        struct = profile if isinstance(profile, dict) else profile.to_dict()
        self._get_db().store_datastore_profile(struct, project=self.name,
                                               private=private)

    def get_datastore_profile(self, name: str):
        return self._get_db().get_datastore_profile(name, project=self.name)

    def list_datastore_profiles(self) -> list:
        return self._get_db().list_datastore_profiles(project=self.name)

    def delete_datastore_profile(self, name: str):
        self._get_db().delete_datastore_profile(name, project=self.name)

    # alerts
    def store_alert_config(self, name: str, config: dict):
        return self._get_db().store_alert_config(name, config,
                                                 project=self.name)

    def get_alert_config(self, name: str) -> dict:
        return self._get_db().get_alert_config(name, project=self.name)

    def list_alerts_configs(self) -> list:
        return self._get_db().list_alert_configs(project=self.name)

    def delete_alert_config(self, name: str):
        self._get_db().delete_alert_config(name, project=self.name)

    def get_alert_template(self, name: str) -> dict:
        """A builtin alert template."""
        from ..service.alerts import get_alert_template

        return get_alert_template(name)

    def list_alert_templates(self) -> list:
        from ..service.alerts import list_alert_templates

        return list_alert_templates()

    def create_alert_from_template(self, name: str, template: str,
                                   entity_id: str = "*",
                                   notifications: list | None = None):
        """Instantiate a builtin template as this project's alert config
        (the template -> config flow)."""
        config = self.get_alert_template(template)
        config["name"] = name
        config["entity_id"] = entity_id
        if notifications:
            config["notifications"] = notifications
        self.store_alert_config(name, config)
        return config

    def reset_alert_config(self, name: str):
        """Clear an alert's silencing window + fired state."""
        alert = self.get_alert_config(name)
        alert["silence_until"] = ""
        alert.pop("last_fired", None)
        self.store_alert_config(name, alert)

    # model monitoring
    def enable_model_monitoring(self, default_apps: bool = True,
                                **kwargs) -> "MlrunProject":
        self.spec.params["model_monitoring_enabled"] = True
        if default_apps:
            apps = self.spec.params.setdefault(
                "model_monitoring_apps", [])
            for default in ("HistogramDataDriftApplication",
                            "LatencyApplication"):
                if default not in apps:
                    apps.append(default)
        return self

    def disable_model_monitoring(self) -> "MlrunProject":
        self.spec.params["model_monitoring_enabled"] = False
        return self

    def set_model_monitoring_function(self, name: str,
                                      application_class: str = "",
                                      **kwargs):
        apps = self.spec.params.setdefault("model_monitoring_apps", [])
        entry = application_class or name
        if entry not in apps:
            apps.append(entry)
        return entry

    def list_model_monitoring_functions(self) -> list:
        return list(self.spec.params.get("model_monitoring_apps", []))

    def remove_model_monitoring_function(self, name: str):
        apps = self.spec.params.get("model_monitoring_apps", [])
        if name in apps:
            apps.remove(name)

    # api gateways
    def list_api_gateways(self) -> list:
        db = self._get_db()
        lister = getattr(db, "list_api_gateways", None)
        if lister:
            return lister(self.name)
        return [f for f in db.list_functions(project=self.name)
                if f.get("kind") == "api-gateway"]

    # git remotes
    def _git(self, *args, check: bool = True):
        return subprocess.run(["git", "-C", self.spec.context or "./",
                               *args], check=check, capture_output=True,
                              text=True)

    def create_remote(self, url: str, name: str = "origin",
                      branch: str = ""):
        self._git("remote", "add", name, url)
        self.spec.origin_url = url

    def set_remote(self, url: str, name: str = "origin", overwrite=True):
        existing = self._git("remote", check=False).stdout.split()
        if name in existing:
            if not overwrite:
                raise ValueError(f"remote {name} exists")
            self._git("remote", "set-url", name, url)
        else:
            self._git("remote", "add", name, url)
        self.spec.origin_url = url

    def remove_remote(self, name: str):
        self._git("remote", "remove", name)

    def pull(self, remote: str = "origin", branch: str = ""):
        self._git("pull", remote, *( [branch] if branch else [] ))

    def push(self, branch: str, message: str = "", update: bool = True,
             remote: str = "origin", add: list | None = None):
        if add:
            self._git("add", *add)
        if update:
            self.save()
            self._git("add", "project.yaml", check=False)
        if message:
            self._git("commit", "-m", message, check=False)
        self._git("push", remote, branch)

    # lifecycle
    def save_to_db(self, store: bool = True):
        return self.save(store=store)

    def save_workflow(self, name: str, target: str, artifact_path: str = "",
                      ttl=None):
        """Export a named workflow spec to a file."""
        workflow = self.spec.get_workflow(name)
        if workflow is None:
            raise ValueError(f"workflow {name} not found in project spec")
        with open(target, "w") as f:
            yaml.safe_dump(dict(workflow), f)

    def reload(self, sync: bool = False, context: str = "",
               ) -> "MlrunProject":
        """Re-load the project from its context dir."""
        project = load_project(context=context or self.spec.context or "./",
                               name=self.name, save=False,
                               sync_functions=sync)
        self.spec = project.spec
        self.status = project.status
        return self

    def setup(self, save: bool = True) -> "MlrunProject":
        """Run the project_setup.py hook from the context dir: a `setup(project) -> project` function customizing the
        loaded project."""
        setup_file = os.path.join(self.spec.context or "./",
                                  self.spec.subpath or "",
                                  "project_setup.py")
        if not os.path.isfile(setup_file):
            return self
        import importlib.util

        module_spec = importlib.util.spec_from_file_location(
            "project_setup", setup_file)
        module = importlib.util.module_from_spec(module_spec)
        module_spec.loader.exec_module(module)
        if hasattr(module, "setup"):
            project = module.setup(self)
            if project is not None and save:
                project.save()
            return project or self
        return self

    def get_function_objects(self) -> dict:
        """Initialized function objects by name."""
        self.sync_functions()
        return dict(self._function_objects)

    def get_run_status(self, run, timeout: float = 600,
                       expected_statuses=None):
        """Wait for a workflow/pipeline run and return it."""
        wait = getattr(run, "wait_for_completion", None)
        if wait:
            wait(timeout=timeout)
        return run

    def save(self, filepath: str = "", store: bool = True):
        self.metadata.created = self.metadata.created or now_iso()
        filepath = filepath or os.path.join(
            self.spec.context or "./", "project.yaml")
        os.makedirs(os.path.dirname(os.path.abspath(filepath)), exist_ok=True)
        with open(filepath, "w") as fp:
            fp.write(self.to_yaml())
        if store:
            self._get_db().store_project(self.name, self.to_dict())
        return self

    def export(self, filepath: str = ""):
        return self.save(filepath, store=False)

    def register_artifacts(self):
        for entry in self.spec.artifacts:
            try:
                self.log_artifact(
                    entry.get("key"),
                    target_path=entry.get("target_path") or entry.get("url"),
                    kind=entry.get("kind", "artifact"), upload=False)
            except Exception as exc:  # noqa: BLE001
                logger.warning("failed to register artifact",
                               key=entry.get("key"), error=str(exc))


def new_project(name: str, context: str = "./", init_git: bool = False,
                user_project: bool = False, remote: str | None = None,
                from_template: str | None = None, secrets: dict | None = None,
                description: str = "", subpath: str = "",
                save: bool = True, overwrite: bool = False,
                parameters: dict | None = None,
                default_image: str | None = None) -> MlrunProject:
    """Create a new project."""
    global _current_project

    name = normalize_name(name)
    if user_project:
        user = os.environ.get("USER", os.environ.get("USERNAME", "user"))
        name = f"{name}-{user.lower()}"
    project = MlrunProject(
        metadata=ProjectMetadata(name=name),
        spec=ProjectSpec(description=description, context=context,
                         subpath=subpath, params=parameters or {},
                         default_image=default_image))
    if from_template:
        loaded = _load_project_file(from_template)
        project.spec.functions = loaded.spec.functions
        project.spec.workflows = loaded.spec.workflows
        project.spec.artifacts = loaded.spec.artifacts
    if init_git:
        try:
            subprocess.run(["git", "init", context], capture_output=True,
                           check=False)
        except OSError:
            pass
    if secrets:
        project.set_secrets(secrets)
    if save:
        project.save()
    _current_project = project
    return project


def load_project(context: str = "./", url: str | None = None,
                 name: str | None = None, secrets: dict | None = None,
                 init_git: bool = False, subpath: str = "",
                 clone: bool = False, user_project: bool = False,
                 save: bool = True, sync_functions: bool = False) -> MlrunProject:
    """Load a project from context dir / git url / yaml."""
    global _current_project

    if url and (url.endswith(".git") or url.startswith("git://")):
        if clone and os.path.isdir(context) and os.listdir(context):
            shutil.rmtree(context)
        subprocess.run(["git", "clone", url.replace("git://", "https://"),
                        context], check=True, capture_output=True)
    project_file = url if url and url.endswith((".yaml", ".yml")) else \
        os.path.join(context, subpath or "", "project.yaml")
    if os.path.isfile(project_file):
        project = _load_project_file(project_file)
    else:
        if not name:
            raise ValueError(
                f"project file not found at {project_file} and no name given")
        project = MlrunProject(metadata=ProjectMetadata(name=name))
    if name:
        project.metadata.name = normalize_name(name)
    project.spec.context = context
    project.spec.subpath = subpath or project.spec.subpath
    if secrets:
        project.set_secrets(secrets)
    if save:
        project.save()
    if sync_functions:
        project.sync_functions()
    _current_project = project
    return project


def get_or_create_project(name: str, context: str = "./",
                          url: str | None = None, secrets: dict | None = None,
                          init_git: bool = False, subpath: str = "",
                          clone: bool = False, user_project: bool = False,
                          from_template: str | None = None,
                          save: bool = True,
                          parameters: dict | None = None) -> MlrunProject:
    """Load from the DB if it exists, else create."""
    global _current_project

    from ..db import get_run_db

    name_n = normalize_name(name)
    try:
        struct = get_run_db().get_project(name_n)
    except Exception:  # noqa: BLE001
        struct = None
    if struct:
        project = MlrunProject.from_dict(struct)
        project.spec.context = context
        _current_project = project
        return project
    try:
        return load_project(context=context, url=url, name=name_n,
                            secrets=secrets, init_git=init_git,
                            subpath=subpath, clone=clone,
                            user_project=user_project, save=save)
    except (ValueError, FileNotFoundError, subprocess.CalledProcessError):
        return new_project(name_n, context=context, init_git=init_git,
                           user_project=user_project, secrets=secrets,
                           from_template=from_template, save=save,
                           parameters=parameters)


def get_current_project(silent: bool = False) -> MlrunProject | None:
    if _current_project is None and not silent:
        raise ValueError("no active project (use new/load/get_or_create)")
    return _current_project


def _load_project_file(path: str) -> MlrunProject:
    with open(path) as fp:
        struct = yaml.safe_load(fp)
    return MlrunProject.from_dict(struct or {})
