"""Workflow engines — the port's copy of ``mlrun_tpu/projects/pipelines.py``.

The local engine executes the step DAG in this process in the workflow
function's order; ``compile_kfp_pipeline`` emits the same DAG as a KFP v2
``PipelineSpec`` IR dict without the kfp package, each step an executor
running the port's CLI (``python3 -m mlrun_tpu_torch run --from-env``).
The kfp engine needs the kfp SDK (an ImportError without it); the remote
engine submits the workflow to the service (``submit_pipeline``).
"""

from __future__ import annotations

import importlib.util
import os
import threading
import time
import uuid
from typing import Callable, Optional

from ..common.runtimes_constants import RunStates
from ..config import RUN_FROM_ENV_COMMAND, run_config
from ..model import RunObject
from ..utils.logger import logger


class PipelineStep:
    """A deferred function invocation inside a workflow (fn.as_step)."""

    def __init__(self, function=None, runspec=None, handler=None, name="",
                 project="", params=None, inputs=None, outputs=None,
                 artifact_path="", image="", returns=None, **kwargs):
        self.function = function
        self.runspec = runspec
        self.handler = handler
        self.name = name or (function.metadata.name if function else "step")
        self.project = project
        self.params = params or {}
        self.inputs = inputs or {}
        self.outputs = outputs or []
        self.returns = returns
        self.artifact_path = artifact_path
        self.image = image
        self.kwargs = kwargs
        self.after_steps: list["PipelineStep"] = []
        self._run: Optional[RunObject] = None

    def after(self, *steps: "PipelineStep") -> "PipelineStep":
        self.after_steps.extend(steps)
        return self

    @property
    def outputs_resolved(self) -> dict:
        if self._run is None:
            return {}
        return self._run.outputs

    def output(self, key: str):
        """Reference a named output of this step (resolved lazily when the
        local engine executes)."""
        return _StepOutput(self, key)

    def run(self, context: "PipelineContext") -> RunObject:
        params = {
            key: (value.resolve() if isinstance(value, _StepOutput) else value)
            for key, value in self.params.items()
        }
        inputs = {
            key: (value.resolve() if isinstance(value, _StepOutput) else value)
            for key, value in self.inputs.items()
        }
        function = self.function
        if self.image:
            function.spec.image = self.image
        run = function.run(
            self.runspec, handler=self.handler, name=self.name,
            project=self.project or context.project_name, params=params,
            inputs=inputs, artifact_path=self.artifact_path
            or context.artifact_path, local=context.local,
            watch=context.watch, returns=self.returns, **self.kwargs)
        self._run = run
        return run


class _StepOutput:
    def __init__(self, step: PipelineStep, key: str):
        self.step = step
        self.key = key

    def resolve(self):
        if self.step._run is None:
            raise RuntimeError(
                f"step '{self.step.name}' has not executed yet")
        value = self.step._run.output(self.key)
        if value is None:
            raise KeyError(
                f"step '{self.step.name}' has no output '{self.key}'")
        return value


class PipelineContext:
    """State for one workflow execution.

    ``engine="kfp-compile"`` traces the workflow without executing it:
    ``run_function`` records each step in :attr:`steps` and returns the
    step object so workflow files can keep chaining ``.after()`` /
    ``.output()`` exactly as they do under the local engine.
    """

    def __init__(self, project=None, workflow_name: str = "", local=True,
                 watch=False, artifact_path: str = "", args: dict | None = None,
                 engine: str = "local"):
        self.steps: list[PipelineStep] = []
        self.project = project
        self.project_name = project.name if project is not None else ""
        self.workflow_name = workflow_name
        self.local = local
        self.watch = watch
        self.artifact_path = artifact_path
        self.args = args or {}
        self.engine = engine
        self.workflow_id = uuid.uuid4().hex
        self.runs: list[RunObject] = []
        self.state = RunStates.running
        self.error: Optional[str] = None


# module-level pipeline context used by workflow python files
_current_context: Optional[PipelineContext] = None
_context_lock = threading.Lock()


def pipeline_context() -> Optional[PipelineContext]:
    return _current_context


class _PipelineRunStatus:
    """Returned by project.run()."""

    def __init__(self, run_id: str, engine: "_PipelineRunner", project,
                 workflow=None, state: str = ""):
        self.run_id = run_id
        self._engine = engine
        self.project = project
        self.workflow = workflow
        self._state = state
        self.runs: list[RunObject] = []
        self.error: Optional[str] = None

    @property
    def state(self) -> str:
        return self._state

    def wait_for_completion(self, timeout=3600, expected_statuses=None):
        return self._engine.wait_for_completion(
            self, timeout=timeout, expected_statuses=expected_statuses)

    def __str__(self):
        return self.run_id


class _PipelineRunner:
    engine = "base"

    @classmethod
    def run(cls, project, workflow_spec, name="", workflow_handler=None,
            secrets=None, artifact_path=None, namespace=None, source=None,
            args=None, local=True, watch=False) -> _PipelineRunStatus:
        raise NotImplementedError

    @classmethod
    def wait_for_completion(cls, run_status, timeout=3600,
                            expected_statuses=None):
        return run_status.state


class _LocalRunner(_PipelineRunner):
    """Execute workflow steps inline."""

    engine = "local"

    @classmethod
    def run(cls, project, workflow_spec, name="", workflow_handler=None,
            secrets=None, artifact_path=None, namespace=None, source=None,
            args=None, local=True, watch=False) -> _PipelineRunStatus:
        global _current_context

        handler = workflow_handler or _load_workflow_handler(
            workflow_spec, project)
        context = PipelineContext(
            project=project, workflow_name=name, local=local, watch=watch,
            artifact_path=artifact_path or project.spec.artifact_path,
            args=args)
        with _context_lock:
            _current_context = context
        status = _PipelineRunStatus(context.workflow_id, cls, project,
                                    workflow=workflow_spec)
        try:
            handler(**(args or {}))
            context.state = RunStates.completed
        except Exception as exc:  # noqa: BLE001 - workflow error → status
            context.state = RunStates.error
            context.error = str(exc)
            logger.error("workflow failed", name=name, error=str(exc))
        finally:
            with _context_lock:
                _current_context = None
        status._state = context.state
        status.runs = context.runs
        status.error = context.error
        if context.state == RunStates.error:
            raise RuntimeError(f"workflow {name} failed: {context.error}")
        return status


class _RemoteRunner(_PipelineRunner):
    """Submit the workflow to the service, whose workflow runner runs it
    with the local engine."""

    engine = "remote"

    @classmethod
    def run(cls, project, workflow_spec, name="", workflow_handler=None,
            secrets=None, artifact_path=None, namespace=None, source=None,
            args=None, local=False, watch=False) -> _PipelineRunStatus:
        from ..db import get_run_db

        db = get_run_db()
        run_id = db.submit_pipeline(
            project.name, workflow_spec if isinstance(workflow_spec, dict)
            else workflow_spec.to_dict(),
            arguments=args, artifact_path=artifact_path)
        return _PipelineRunStatus(run_id, cls, project, workflow=workflow_spec,
                                  state=RunStates.running)

    @classmethod
    def wait_for_completion(cls, run_status, timeout=3600,
                            expected_statuses=None):
        return wait_for_run_completion(
            run_status.run_id, timeout=timeout,
            project=run_status.project.name,
            expected_statuses=expected_statuses)


def _step_exec_env(step: "PipelineStep", artifact_path: str,
                   params: dict | None = None,
                   inputs: dict | None = None) -> list[dict]:
    """The in-pod contract env for one step (the CLI's ``run --from-env``
    with MLT_EXEC_CONFIG / MLT_EXEC_CODE). Shared by the kfp-free IR
    compiler and the kfp-SDK container-op builder so the contract can't
    drift."""
    import json as jsonlib

    function = step.function
    run = {
        "metadata": {"name": step.name,
                     "project": function.metadata.project},
        "spec": {"parameters": step.params if params is None else params,
                 "inputs": step.inputs if inputs is None else inputs,
                 "handler": step.handler or function.spec.default_handler,
                 "output_path": step.artifact_path or artifact_path,
                 "function": function.uri},
    }
    env = [{"name": "MLT_EXEC_CONFIG",
            "value": jsonlib.dumps(run, default=str)}]
    build = function.spec.build
    if build and getattr(build, "functionSourceCode", ""):
        env.append({"name": "MLT_EXEC_CODE",
                    "value": build.functionSourceCode})
    return env


def compile_kfp_pipeline(project, workflow_spec=None, name: str = "",
                         workflow_handler=None, artifact_path: str = "",
                         args: dict | None = None) -> dict:
    """Compile a workflow to a KFP v2 ``PipelineSpec`` IR dict WITHOUT the
    kfp package (the IR schema is plain JSON, so emitting it directly
    keeps the compile path executable without kfp — submission to a KFP
    endpoint still requires the kfp client, see _KFPRunner.run).

    Each step becomes an executor running the in-pod contract
    (``RUN_FROM_ENV_COMMAND``);
    ``.after()`` chains and ``step.output()`` references become dag
    dependencies. Step-output params are declared as component
    input/output parameter definitions and injected into the exec config
    via KFP runtime placeholders (``{{$.inputs.parameters['k']}}``) so
    the backend substitutes the produced value at run time.
    """
    global _current_context

    handler = workflow_handler or _load_workflow_handler(
        workflow_spec, project)
    context = PipelineContext(
        project=project, workflow_name=name, local=False,
        artifact_path=artifact_path or project.spec.artifact_path,
        args=args, engine="kfp-compile")
    with _context_lock:
        _current_context = context
    try:
        handler(**(args or {}))
    finally:
        with _context_lock:
            _current_context = None

    # unique task names: duplicate step names get -2/-3… suffixes (like the
    # kfp SDK) so later steps can't silently overwrite earlier ones
    task_names: dict[int, str] = {}
    used: dict[str, int] = {}
    for step in context.steps:
        count = used.get(step.name, 0) + 1
        used[step.name] = count
        task_names[id(step)] = (step.name if count == 1
                                else f"{step.name}-{count}")

    # producer steps must declare every output key a consumer references
    produced: dict[int, set] = {}
    for step in context.steps:
        for value in {**step.params, **step.inputs}.values():
            if isinstance(value, _StepOutput):
                produced.setdefault(id(value.step), set()).add(value.key)

    executors: dict = {}
    components: dict = {}
    tasks: dict = {}
    for step in context.steps:
        task_name = task_names[id(step)]
        deps = {task_names[id(dep)] for dep in step.after_steps
                if id(dep) in task_names}
        task_inputs: dict = {}
        static_params: dict = {}
        static_inputs: dict = {}
        dyn_args: list = []
        for key, value, bucket, flag in (
                [(k, v, static_params, "--str-param")
                 for k, v in step.params.items()]
                + [(k, v, static_inputs, "--inputs")
                   for k, v in step.inputs.items()]):
            if isinstance(value, _StepOutput):
                producer = task_names[id(value.step)]
                deps.add(producer)
                task_inputs[key] = {"taskOutputParameter": {
                    "producerTask": producer,
                    "outputParameterKey": value.key}}
                # dynamic values ride in ARGS: the KFP launcher substitutes
                # {{$...}} runtime placeholders in command/args only, so an
                # env-embedded placeholder would arrive verbatim; the
                # --from-env entrypoint merges --str-param/--inputs over
                # MLT_EXEC_CONFIG (__main__.py run)
                dyn_args += [flag,
                             f"{key}={{{{$.inputs.parameters['{key}']}}}}"]
            else:
                bucket[key] = value

        env = _step_exec_env(step, context.artifact_path,
                             params=static_params, inputs=static_inputs)
        # output-parameter paths ride in ARGS for the same reason
        # (__main__.py --kfp-output writes run results to those paths)
        out_args = list(dyn_args)
        for key in sorted(produced.get(id(step), ())):
            out_args += ["--kfp-output",
                         f"{key}={{{{$.outputs.parameters['{key}']"
                         f".output_file}}}}"]
        container = {
            "image": step.function.full_image_path(),
            "command": list(RUN_FROM_ENV_COMMAND),
            "env": env,
        }
        if out_args:
            container["args"] = out_args
        executors[f"exec-{task_name}"] = {"container": container}
        component: dict = {"executorLabel": f"exec-{task_name}"}
        if task_inputs:
            component["inputDefinitions"] = {"parameters": {
                key: {"parameterType": "STRING"} for key in task_inputs}}
        if produced.get(id(step)):
            component["outputDefinitions"] = {"parameters": {
                key: {"parameterType": "STRING"}
                for key in sorted(produced[id(step)])}}
        components[f"comp-{task_name}"] = component

        task = {"componentRef": {"name": f"comp-{task_name}"},
                "taskInfo": {"name": task_name}}
        if deps:
            task["dependentTasks"] = sorted(deps)
        if task_inputs:
            task["inputs"] = {"parameters": task_inputs}
        tasks[task_name] = task

    return {
        "pipelineInfo": {"name": name or context.workflow_id},
        "schemaVersion": "2.1.0",
        "sdkVersion": "mlrun-tpu",
        "deploymentSpec": {"executors": executors},
        "components": components,
        "root": {"dag": {"tasks": tasks}},
    }


class _KFPRunner(_PipelineRunner):
    """Compile the workflow to Kubeflow Pipelines when kfp is available.
    The kfp-free compile path is :func:`compile_kfp_pipeline`."""

    engine = "kfp"
    compile = staticmethod(compile_kfp_pipeline)

    @staticmethod
    def _step_to_container_op(step: "PipelineStep", artifact_path: str):
        """One workflow step → a KFP container op running the in-pod
        contract (the CLI's ``run --from-env``)."""
        import kfp.dsl as dsl

        op = dsl.ContainerOp(
            name=step.name,
            image=step.function.full_image_path(),
            command=list(RUN_FROM_ENV_COMMAND),
        )
        for item in _step_exec_env(step, artifact_path):
            op.container.add_env_variable(item)
        return op

    @classmethod
    def run(cls, project, workflow_spec, name="", workflow_handler=None,
            secrets=None, artifact_path=None, namespace=None, source=None,
            args=None, local=False, watch=False) -> _PipelineRunStatus:
        try:
            import kfp
        except ImportError as exc:
            raise ImportError(
                "the kfp engine requires the 'kfp' package; use "
                "engine='local' or engine='remote' instead") from exc

        global _current_context

        handler = workflow_handler or _load_workflow_handler(
            workflow_spec, project)
        # during kfp tracing, run_function emits container ops (engine=kfp
        # in the pipeline context) instead of executing steps
        compile_context = PipelineContext(
            project=project, workflow_name=name, local=False,
            artifact_path=artifact_path or project.spec.artifact_path,
            args=args, engine="kfp")

        def traced_handler(*handler_args, **handler_kwargs):
            global _current_context

            with _context_lock:
                _current_context = compile_context
            try:
                return handler(*handler_args, **handler_kwargs)
            finally:
                with _context_lock:
                    _current_context = None

        client = kfp.Client(namespace=namespace) if namespace else \
            kfp.Client()
        run_result = client.create_run_from_pipeline_func(
            traced_handler, arguments=args or {},
            experiment_name=project.name)
        return _PipelineRunStatus(str(run_result.run_id), cls, project,
                                  workflow=workflow_spec,
                                  state=RunStates.running)


def get_workflow_engine(engine: str = "", local: bool = False):
    if local or engine in ("", "local"):
        return _LocalRunner
    if engine == "remote":
        return _RemoteRunner
    if engine == "kfp":
        return _KFPRunner
    raise ValueError(f"unsupported workflow engine '{engine}'")


def _load_workflow_handler(workflow_spec, project) -> Callable:
    path = workflow_spec.get("path") if isinstance(workflow_spec, dict) \
        else getattr(workflow_spec, "path", "")
    handler_name = (workflow_spec.get("handler")
                    if isinstance(workflow_spec, dict)
                    else getattr(workflow_spec, "handler", "")) or "pipeline"
    if not path:
        raise ValueError("workflow has no code path")
    if project is not None and project.spec.context and not os.path.isabs(path):
        path = os.path.join(project.spec.context, path)
    module_name = os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    if not hasattr(module, handler_name):
        # fall back to any function decorated or named main
        for candidate in ("main", "kfpipeline", "workflow"):
            if hasattr(module, candidate):
                handler_name = candidate
                break
        else:
            raise ValueError(
                f"workflow handler '{handler_name}' not found in {path}")
    return getattr(module, handler_name)


def load_and_run(context, url: str = "", project_name: str = "",
                 workflow_name: str = "", workflow_path: str = "",
                 workflow_arguments: dict | None = None,
                 artifact_path: str = ""):
    """Entry of the service's workflow-runner job: load the project in
    the working directory and run one workflow on the local engine."""
    from . import load_project

    project = load_project(context="./", url=url, name=project_name)
    return project.run(
        name=workflow_name, workflow_path=workflow_path,
        arguments=workflow_arguments, artifact_path=artifact_path,
        engine="local")


def wait_for_run_completion(run_id, timeout: float = 3600, project: str = "",
                            expected_statuses: list | None = None) -> str:
    """Poll the service for a workflow run's state."""
    from ..db import get_run_db

    db = get_run_db()
    deadline = time.monotonic() + timeout
    state = RunStates.running
    while time.monotonic() < deadline:
        try:
            resp = db.api_call(
                "GET", f"projects/{project or run_config('default_project')}/"
                f"workflows/{run_id}")
            state = resp.get("state", RunStates.running)
        except Exception:  # noqa: BLE001 - transient api errors tolerated
            pass
        if state in RunStates.terminal_states():
            break
        time.sleep(2)
    if expected_statuses and state not in expected_statuses:
        raise RuntimeError(f"workflow {run_id} ended in state {state}")
    return state
