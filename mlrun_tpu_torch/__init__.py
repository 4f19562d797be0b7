"""mlrun_tpu_torch — the PyTorch/CUDA port of mlrun_tpu for NVIDIA H100.

Mirrors the structure of ``mlrun_tpu/`` module for module. It imports
``torch`` and never ``jax``, and nothing of ``mlrun_tpu``: what it needs of
the host-side modules it keeps as its own copies. Each Pallas kernel on a
ported path is a hand-written CUDA kernel under ``csrc/``, built at first
use (ops/_build.py), with a plain PyTorch version beside it.

The run stack and projects are at the top level as in the reference:
``new_function`` (e.g. ``new_function("train", kind="tpujob").run(
handler=train, local=True)``), ``get_run_db``, ``MLClientCtx``,
``get_or_create_ctx``, ``code_to_function``, ``import_function`` (also
``hub://`` functions), ``new_project`` / ``load_project`` /
``get_or_create_project`` / ``get_current_project`` and ``run_function``;
so are the reference's other top-level names: ``get_dataitem``,
``get_object``, ``get_pipeline``, ``pipeline_context``, the mounts, the
errors, the run objects, the packagers, ``handler``, ``Version``,
``set_environment`` and ``set_env_from_file``. The CLI is ``python3 -m
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
    "get_dataitem": "mlrun_tpu_torch.run",
    "get_object": "mlrun_tpu_torch.run",
    "get_pipeline": "mlrun_tpu_torch.run",
    "pipeline_context": "mlrun_tpu_torch.run",
    "set_environment": "mlrun_tpu_torch.run",
    "set_env_from_file": "mlrun_tpu_torch.run",
    "auto_mount": "mlrun_tpu_torch.platforms",
    "mount_pvc": "mlrun_tpu_torch.platforms",
    "get_secret_or_env": "mlrun_tpu_torch.secrets",
    "environ": "os",
    "Version": "mlrun_tpu_torch.utils.version",
    "get_version": "mlrun_tpu_torch.utils.version",
    "ArtifactType": "mlrun_tpu_torch.package",
    "handler": "mlrun_tpu_torch.package",
    "DefaultPackager": "mlrun_tpu_torch.package.packagers.default",
    "Packager": "mlrun_tpu_torch.package",
    "MLRunBaseError": "mlrun_tpu_torch.errors",
    "MLRunConflictError": "mlrun_tpu_torch.errors",
    "MLRunInvalidArgumentError": "mlrun_tpu_torch.errors",
    "MLRunNotFoundError": "mlrun_tpu_torch.errors",
    "MLRunRuntimeError": "mlrun_tpu_torch.errors",
    "MLRunTimeoutError": "mlrun_tpu_torch.errors",
    "new_task": "mlrun_tpu_torch.model",
    "RunObject": "mlrun_tpu_torch.model",
    "RunTemplate": "mlrun_tpu_torch.model",
    "HyperParamOptions": "mlrun_tpu_torch.model",
    "Notification": "mlrun_tpu_torch.model",
}


def __getattr__(name: str):
    module = _LAZY_EXPORTS.get(name)
    if module is None:
        raise AttributeError(
            f"module 'mlrun_tpu_torch' has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(module), name)
