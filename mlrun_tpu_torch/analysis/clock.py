"""MLT003 — explicit-now discipline in control loops.

Every interval-evaluator in this codebase takes an explicit ``now``
(``FleetAutoscaler.tick(now)``, ``ContinuousTuningController.tick(now)``,
``SLOEvaluator.evaluate(at)``, the canary hash split) so fake-clock
tests can drive hours of control-loop behavior in milliseconds — the
property every closed-loop test (scale ramp, promote/rollback,
burn-rate windows) rests on. One ``time.time()`` inside a tick body
silently re-couples the loop to the wall clock and the fake-clock
suite starts passing for the wrong reason.

The check: in the control-loop modules listed below, no call to
``time.time / time.monotonic / time.perf_counter / datetime.now /
datetime.utcnow`` anywhere — the clock must arrive as an argument.
Legitimate wall-clock sites (entrypoints that SOURCE the clock before
threading it down) go in the per-module allowlist with a rationale.
"""

from __future__ import annotations

import ast
import os

from .core import Checker, Finding, qualname_parts, walk_functions, walk_own

CODE = "MLT003"

#: module (repo-relative) -> why it is clock-disciplined
CONTROL_LOOP_MODULES = {
    "mlrun_tpu_torch/service/autoscaler.py":
        "FleetAutoscaler.tick(now) — fake-clock scale-ramp tests",
    "mlrun_tpu_torch/model_monitoring/controller.py":
        "ContinuousTuningController.tick(now) — fake-clock closed loop",
    "mlrun_tpu_torch/model_monitoring/stream_processing.py":
        "AdapterTrafficMonitor.evaluate(adapter, now) — drift windows",
    "mlrun_tpu_torch/obs/health.py":
        "ReplicaHealthScorer.tick(now) — fake-clock fail-slow "
        "detection drills",
    "mlrun_tpu_torch/obs/slo.py":
        "SLOEvaluator.evaluate(at) — burn-rate window arithmetic",
    "mlrun_tpu_torch/obs/timeseries.py":
        "windowed store: record/rate/quantile all take explicit times",
    "mlrun_tpu_torch/serving/canary.py":
        "CanaryRouter: deterministic hash split, no time dependence",
    "mlrun_tpu_torch/training/elastic.py":
        "ElasticGuard.poll — chaos-driven slice failures, fake-clock",
    "mlrun_tpu_torch/common/journal.py":
        "intent journal: records carry caller-provided times only — a "
        "journal-stamped wall clock would diverge from the fake clock "
        "the recovery drills replay under",
    "mlrun_tpu_torch/serving/podfleet.py":
        "ServingPodFleet.tick(now)/reconcile(now) — fake-clock restart "
        "and preemption drills",
}

#: (module, function qualname) -> rationale for a legitimate
#: wall-clock read inside a clock-disciplined module. Entrypoints that
#: SOURCE the clock belong here; tick/evaluate bodies never do.
ALLOWLIST: dict[tuple[str, str], str] = {
    ("mlrun_tpu_torch/serving/podfleet.py",
     "ServingPodFleet._advance_warming"):
        "perf_counter measures the REAL pre-warm wall (compile + KV "
        "replay work) for the prewarm histogram — real work, not "
        "control-loop scheduling, so the fake clock must not apply",
    ("mlrun_tpu_torch/serving/podfleet.py", "ServingPodFleet.reconcile"):
        "perf_counter measures the real recovery wall (journal replay "
        "+ world listing + adoption) for mlt_reconcile_seconds — same "
        "real-work rule as _advance_warming",
}

_CLOCK_CALLS = {
    ("time", "time"), ("time", "monotonic"), ("time", "perf_counter"),
    ("datetime", "now"), ("datetime", "utcnow"),
    ("datetime", "datetime", "now"), ("datetime", "datetime", "utcnow"),
}
_BARE_CLOCK_IMPORTS = {"time", "monotonic", "perf_counter"}


class ExplicitNowChecker(Checker):
    code = CODE
    name = "explicit-now"

    def begin(self, root: str) -> None:
        self._root = root

    def visit(self, tree, source: str, path: str) -> list[Finding]:
        rel = os.path.relpath(path, self._root).replace(os.sep, "/")
        if rel not in CONTROL_LOOP_MODULES:
            return []
        findings: list[Finding] = []
        # names bound by ``from time import time`` style imports
        bare: set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) \
                    and node.module in ("time", "datetime"):
                for alias in node.names:
                    if alias.name in _BARE_CLOCK_IMPORTS | {"now"}:
                        bare.add(alias.asname or alias.name)
        for func, qual in walk_functions(tree):
            if (rel, qual) in ALLOWLIST:
                continue
            for node in walk_own(func):
                if not isinstance(node, ast.Call):
                    continue
                if self._is_clock_call(node, bare):
                    findings.append(Finding(
                        CODE, path, node.lineno,
                        f"wall-clock read inside {qual} of a "
                        f"clock-disciplined module "
                        f"({CONTROL_LOOP_MODULES[rel]})",
                        "take `now` as a parameter (the interval "
                        "evaluator convention) or add an ALLOWLIST "
                        "entry with a rationale"))
        # import-time clock reads: module level AND class bodies
        # (a class attribute default like `_epoch = time.time()` runs
        # at import and re-couples the module to the wall clock just
        # as surely as a call inside tick())
        for sub in _walk_outside_functions(tree):
            if isinstance(sub, ast.Call) \
                    and self._is_clock_call(sub, bare):
                findings.append(Finding(
                    CODE, path, sub.lineno,
                    "import-time wall-clock read in a "
                    "clock-disciplined module",
                    "thread the clock in as an argument"))
        return findings

    @staticmethod
    def _is_clock_call(node: ast.Call, bare: set[str]) -> bool:
        parts = qualname_parts(node.func)
        if parts is None:
            return False
        if tuple(parts) in _CLOCK_CALLS:
            return True
        return len(parts) == 1 and parts[0] in bare


def _walk_outside_functions(tree):
    """Every node that executes at import time: descends into class
    bodies but not into function/lambda bodies."""
    stack = list(ast.iter_child_nodes(tree))
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield node
        stack.extend(ast.iter_child_nodes(node))


