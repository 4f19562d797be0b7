"""Launcher base — the port's copy of ``mlrun_tpu/launcher/base.py``. A
launcher is the strategy object that takes a (runtime, task) pair and
executes it. The run enrichment, the hyper-param fan-out with its selector
and stop condition, the notification push and ``_log_track_results`` live
here so every execution path shares them.
"""

from __future__ import annotations

import socket
from abc import ABC, abstractmethod

from ..common.runtimes_constants import RunStates
from ..config import resolve_artifact_path, run_config
from ..execution import MLClientCtx
from ..model import RunObject
from ..runtimes.generators import get_generator, select_best_iteration
from ..utils.helpers import generate_uid, get_in, template_artifact_path
from ..utils.logger import logger


class BaseLauncher(ABC):
    @abstractmethod
    def launch(self, runtime, task: RunObject, schedule=None, watch=True,
               auto_build=False, **kwargs) -> RunObject:
        ...

    # -- enrichment --------------------------------------------------------
    def enrich_runtime(self, runtime, project_name: str = ""):
        runtime.metadata.project = (
            runtime.metadata.project or project_name
            or run_config("default_project"))
        runtime.metadata.name = runtime.metadata.name or "handler"

    def _enrich_run(self, runtime, run: RunObject) -> RunObject:
        run.metadata.uid = run.metadata.uid or generate_uid()
        run.metadata.project = (
            run.metadata.project or runtime.metadata.project
            or run_config("default_project"))
        run.spec.function = runtime.uri
        if not run.spec.output_path:
            run.spec.output_path = resolve_artifact_path(
                run.metadata.project)
        run.spec.output_path = template_artifact_path(
            run.spec.output_path, run.metadata.project, run.metadata.uid)
        handler = run.spec.handler
        if handler and not callable(handler):
            run.spec.handler = str(handler)
        if not run.spec.handler and runtime.spec.default_handler:
            run.spec.handler = runtime.spec.default_handler
        return run

    @staticmethod
    def _validate_run(run: RunObject):
        if run.spec.hyperparams and run.spec.hyper_param_options and \
                run.spec.hyper_param_options.strategy == "list":
            lengths = {len(v) for v in run.spec.hyperparams.values()}
            if len(lengths) > 1:
                raise ValueError("list hyper-param strategy requires equal lists")

    # -- hyper-param orchestration ----------------------------------------
    def _run_with_hyperparams(self, runtime, run: RunObject,
                              execution: MLClientCtx) -> dict:
        """Fan out iterations, collect a summary, select + link the best."""
        if run.spec.hyper_param_options and \
                run.spec.hyper_param_options.param_file:
            from ..runtimes.generators import load_params_file

            loaded = load_params_file(run)
            merged = dict(run.spec.hyperparams or {})
            merged.update(loaded)
            run.spec.hyperparams = merged
        generator = get_generator(run.spec, execution)
        iteration_results = []
        errors = 0

        def run_one(task):
            child_ctx = MLClientCtx.from_dict(
                task.to_dict(), rundb=execution._db,
                host=socket.gethostname())
            try:
                result = runtime._run(task, child_ctx)
            except Exception as exc:  # noqa: BLE001 - iteration failure tolerated
                child_ctx.set_state(error=str(exc))
                result = child_ctx.to_dict()
            return task, result

        def record(task, result) -> bool:
            """Append an iteration row; True → abort the sweep."""
            nonlocal errors
            state = get_in(result, "status.state")
            results = get_in(result, "status.results", {}) or {}
            iteration_results.append({
                "iter": task.metadata.iteration,
                "state": state,
                "results": results,
                "parameters": task.spec.parameters,
            })
            if state == RunStates.error:
                errors += 1
                if errors >= generator.max_errors:
                    execution.set_state(
                        error=f"{errors} iterations failed — aborting sweep")
                    return True
            if generator.eval_stop_condition(results):
                logger.info("stop condition met",
                            iteration=task.metadata.iteration)
                return True
            return False

        if generator.use_parallel():
            # N iterations as concurrent resources with a max-parallel cap;
            # early stop cancels queued iterations instead of draining them
            from concurrent.futures import ThreadPoolExecutor, as_completed

            workers = int(generator.options.parallel_runs)
            pool = ThreadPoolExecutor(max_workers=workers)
            try:
                futures = [pool.submit(run_one, task)
                           for task in generator.generate(run)]
                for future in as_completed(futures):
                    if record(*future.result()):
                        break
            finally:
                pool.shutdown(wait=True, cancel_futures=True)
        else:
            for task in generator.generate(run):
                if record(*run_one(task)):
                    break

        selector = (run.spec.hyper_param_options.selector
                    if run.spec.hyper_param_options else None)
        best = select_best_iteration(iteration_results, selector or "")
        if best:
            best_row = next(
                r for r in iteration_results if r["iter"] == best)
            execution.log_results(best_row["results"])
            # link parent artifacts to the best child iteration
            execution._artifacts_manager.link_artifact(
                execution._producer(), "best_iteration", best)
        execution.log_iteration_results(best, iteration_results, run.to_dict())
        execution.commit(completed=errors < generator.max_errors)
        return execution.to_dict()

    # -- notifications -----------------------------------------------------
    @staticmethod
    def _push_notifications(run: RunObject):
        notifications = run.spec.notifications or []
        if not notifications:
            return
        from ..utils.notifications import NotificationPusher

        try:
            run_dict = run.to_dict()
            NotificationPusher([run_dict]).push()
            # persist sent/error statuses so the server-side monitor does
            # not push the same notifications again on resource retirement
            specs = run_dict.get("spec", {}).get("notifications")
            from ..db import get_run_db

            get_run_db().update_run(
                {"spec.notifications": specs},
                run.metadata.uid, run.metadata.project)
        except Exception as exc:  # noqa: BLE001
            logger.warning("notification push failed", error=str(exc))

    @staticmethod
    def _log_track_results(runtime, result: dict, run: RunObject) -> RunObject:
        run.status = run.status.__class__.from_dict(
            result.get("status", {}))
        state = run.status.state
        if state == RunStates.completed:
            logger.info("run completed", name=run.metadata.name,
                        uid=run.metadata.uid, results=run.status.results)
        elif state == RunStates.error:
            logger.error("run failed", name=run.metadata.name,
                         uid=run.metadata.uid, error=run.status.error)
        return run
