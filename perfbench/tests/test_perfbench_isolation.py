"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the port. Names are compared by their
top-level part (before the first dot) whole: the port's name begins with
the JAX package's."""

import json
import subprocess
import sys

from conftest import BENCH, ROOT

_PROBE = """
import json, sys
sys.path[:0] = [{bench!r}, {root!r}]
import importlib
for name in {modules!r}:
    importlib.import_module(name)
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
"""

HARNESS = ["run", "cells", "models", "traffic", "roofline", "devtrace",
           "readers", "checks", "serve_cell", "train_cell", "calibrate",
           "mlrun_tpu_torch.serving.paged", "mlrun_tpu_torch.training.train"]
REFERENCE = ["reference.dense", "reference.moe"]


def _loaded(modules) -> set:
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(bench=str(BENCH),
                                             root=str(ROOT),
                                             modules=modules)],
        capture_output=True, text=True, timeout=300, check=True,
        env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0", "USE_JAX": "0",
             "HOME": str(ROOT)})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_neither_jax_nor_the_jax_package():
    loaded = _loaded(HARNESS)
    assert "mlrun_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "mlrun_tpu"}


def test_reference_loads_nothing_of_the_port():
    loaded = _loaded(REFERENCE)
    assert "torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "mlrun_tpu",
                         "mlrun_tpu_torch"}


def test_run_refuses_a_result_when_a_forbidden_module_is_loaded(
        monkeypatch):
    import run

    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax"]
    monkeypatch.delitem(sys.modules, "jax.numpy")
    assert "mlrun_tpu" not in run.forbidden_modules()
