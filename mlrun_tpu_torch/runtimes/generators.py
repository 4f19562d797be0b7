"""Hyper-param task generators — the port's copy of
``mlrun_tpu/runtimes/generators.py`` (grid, list and random strategies,
the ``max.<key>`` / ``min.<key>`` selector and the stop condition)."""

from __future__ import annotations

import itertools
import random
from copy import deepcopy
from typing import Iterator

from ..model import HyperParamOptions, RunObject, RunSpec

default_max_iterations = 10
default_max_errors = 3


class TaskGenerator:
    def __init__(self, options: HyperParamOptions | None = None):
        self.options = options or HyperParamOptions()

    def generate(self, run: RunObject) -> Iterator[RunObject]:
        raise NotImplementedError

    @property
    def max_errors(self) -> int:
        return self.options.max_errors or default_max_errors

    def use_parallel(self) -> bool:
        return bool(self.options.parallel_runs)

    def eval_stop_condition(self, results: dict) -> bool:
        condition = self.options.stop_condition
        if not condition:
            return False
        from ..utils.safe_eval import safe_eval

        try:
            return bool(safe_eval(condition, results))
        except Exception:  # noqa: BLE001 - bad condition never stops the sweep
            return False

    @staticmethod
    def _child(run: RunObject, params: dict, iteration: int) -> RunObject:
        child = deepcopy(run)
        child.spec.hyperparams = None
        child.spec.hyper_param_options = None
        child.spec.parameters = dict(run.spec.parameters or {})
        child.spec.parameters.update(params)
        child.metadata.iteration = iteration
        return child


class GridGenerator(TaskGenerator):
    """Cartesian product of all hyper-param lists."""

    def generate(self, run: RunObject) -> Iterator[RunObject]:
        hyperparams = run.spec.hyperparams or {}
        keys = list(hyperparams.keys())
        for iteration, values in enumerate(
                itertools.product(*hyperparams.values()), start=1):
            yield self._child(run, dict(zip(keys, values)), iteration)


class ListGenerator(TaskGenerator):
    """Zip of equal-length hyper-param lists."""

    def generate(self, run: RunObject) -> Iterator[RunObject]:
        hyperparams = run.spec.hyperparams or {}
        lengths = {len(v) for v in hyperparams.values()}
        if len(lengths) > 1:
            raise ValueError(
                f"list strategy requires equal-length lists, got {lengths}")
        keys = list(hyperparams.keys())
        for iteration, values in enumerate(zip(*hyperparams.values()), start=1):
            yield self._child(run, dict(zip(keys, values)), iteration)


class RandomGenerator(TaskGenerator):
    """Random sampling from the grid up to max_iterations."""

    def generate(self, run: RunObject) -> Iterator[RunObject]:
        hyperparams = run.spec.hyperparams or {}
        max_iterations = self.options.max_iterations or default_max_iterations
        for iteration in range(1, max_iterations + 1):
            params = {k: random.choice(v) for k, v in hyperparams.items()}
            yield self._child(run, params, iteration)


def load_params_file(run: RunObject) -> dict:
    """Load hyper params from a csv/json param file (options.param_file)."""
    import json

    from ..datastore import store_manager

    url = run.spec.hyper_param_options.param_file
    item = store_manager.object(url=url)
    if url.endswith(".csv"):
        df = item.as_df()
        return {c: df[c].tolist() for c in df.columns}
    return json.loads(item.get(encoding="utf-8"))


def get_generator(spec: RunSpec, execution=None,
                  param_file_secrets=None) -> TaskGenerator | None:
    options = spec.hyper_param_options or HyperParamOptions()
    if not spec.hyperparams and not options.param_file:
        return None
    strategy = options.strategy or "grid"
    generator_cls = {
        "grid": GridGenerator,
        "list": ListGenerator,
        "random": RandomGenerator,
    }.get(strategy)
    if generator_cls is None:
        raise ValueError(f"unsupported hyper-param strategy '{strategy}'")
    return generator_cls(options)


def selector_value(results: dict, selector: str):
    """Parse 'max.accuracy' / 'min.loss' selectors; return (op, key)."""
    if not selector:
        return None, None
    if "." in selector:
        op, key = selector.split(".", 1)
    else:
        op, key = "max", selector
    if op not in ("max", "min"):
        raise ValueError(f"selector op must be max|min, got '{op}'")
    return op, key


def select_best_iteration(iteration_results: list[dict], selector: str) -> int:
    """Return best iteration number given [{iter, results...}] rows."""
    op, key = selector_value({}, selector)
    if not key:
        return 0
    best_iter, best_value = 0, None
    for row in iteration_results:
        results = row.get("results") or {}
        if key not in results:
            continue
        value = results[key]
        better = (
            best_value is None
            or (op == "max" and value > best_value)
            or (op == "min" and value < best_value)
        )
        if better:
            best_iter, best_value = row.get("iter", 0), value
    return best_iter
