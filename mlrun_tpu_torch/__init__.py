"""mlrun_tpu_torch — the PyTorch/CUDA port of mlrun_tpu for NVIDIA H100.

Mirrors the structure of ``mlrun_tpu/`` module for module. It imports
``torch`` and never ``jax``, and nothing of ``mlrun_tpu``: what it needs of
the host-side modules it keeps as its own copies. Each Pallas kernel on a
ported path is a hand-written CUDA kernel under ``csrc/``, built at first
use (ops/_build.py), with a plain PyTorch version beside it.

The run stack and projects are at the top level as in the reference:
``new_function`` (e.g. ``new_function("train", kind="tpujob").run(
handler=train, local=True)``), ``get_run_db``, ``MLClientCtx``,
``get_or_create_ctx``, ``code_to_function``, ``import_function``,
``new_project`` / ``load_project`` / ``get_or_create_project`` /
``get_current_project`` and ``run_function``. The CLI is ``python3 -m
mlrun_tpu_torch`` (``__main__.py``).
"""

__version__ = "0.1.0"

from .db import get_run_db  # noqa: E402,F401
from .execution import MLClientCtx  # noqa: E402,F401
from .run import new_function  # noqa: E402,F401

# resolved at first use, so that `import mlrun_tpu_torch` stays light
_LAZY_EXPORTS = {
    "code_to_function": "mlrun_tpu_torch.run",
    "function_to_module": "mlrun_tpu_torch.run",
    "get_or_create_ctx": "mlrun_tpu_torch.run",
    "import_function": "mlrun_tpu_torch.run",
    "run_local": "mlrun_tpu_torch.run",
    "wait_for_pipeline_completion": "mlrun_tpu_torch.run",
    "new_project": "mlrun_tpu_torch.projects",
    "load_project": "mlrun_tpu_torch.projects",
    "get_or_create_project": "mlrun_tpu_torch.projects",
    "get_current_project": "mlrun_tpu_torch.projects",
    "run_function": "mlrun_tpu_torch.projects",
    "build_function": "mlrun_tpu_torch.projects",
    "deploy_function": "mlrun_tpu_torch.projects",
    "MlrunProject": "mlrun_tpu_torch.projects",
    "ProjectMetadata": "mlrun_tpu_torch.projects",
}


def __getattr__(name: str):
    module = _LAZY_EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module 'mlrun_tpu_torch' has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(module), name)
