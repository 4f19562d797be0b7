"""Runtimes — the port's copy of ``mlrun_tpu/runtimes``: the function
objects a run executes through (``local``, ``handler``, ``job`` and the
GPU-sized ``tpujob``). The registry's other kinds (``dask``, ``spark``,
``databricks``, ``serving``, ``remote``, ``application``) are the
service's and raise ``not_ported`` item 14 from ``get_runtime_class``."""

from __future__ import annotations

from ..common.runtimes_constants import RuntimeKinds  # noqa: F401
from .base import BaseRuntime, FunctionMetadata, FunctionSpec, FunctionStatus  # noqa: F401
from .generators import get_generator  # noqa: F401
from .local import HandlerRuntime, LocalRuntime  # noqa: F401

# kinds the reference registers whose runtimes the port has not yet
_UNPORTED_KINDS = (RuntimeKinds.dask, RuntimeKinds.spark,
                   RuntimeKinds.databricks, RuntimeKinds.serving,
                   RuntimeKinds.remote, RuntimeKinds.application)


def _registry() -> dict:
    from .kubejob import KubejobRuntime
    from .tpujob import TpuJobRuntime

    return {
        RuntimeKinds.local: LocalRuntime,
        "": LocalRuntime,
        RuntimeKinds.handler: HandlerRuntime,
        RuntimeKinds.job: KubejobRuntime,
        RuntimeKinds.tpujob: TpuJobRuntime,
    }


def get_runtime_class(kind: str) -> type:
    if kind in _UNPORTED_KINDS:
        from ..serving.resilience import not_ported

        raise not_ported(f"the '{kind}' runtime (part 14c)", 14)
    registry = _registry()
    if kind not in registry:
        raise ValueError(
            f"unsupported runtime kind '{kind}', expected one of "
            f"{sorted(k for k in registry if k)}")
    return registry[kind]


def new_runtime(kind: str, struct: dict | None = None) -> BaseRuntime:
    cls = get_runtime_class(kind)
    obj = cls.from_dict(struct or {})
    obj.kind = kind or obj.kind
    return obj
