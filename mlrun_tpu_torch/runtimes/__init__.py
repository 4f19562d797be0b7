"""Runtimes — the port's copy of ``mlrun_tpu/runtimes``: the function
objects a run executes through (``local``, ``handler``, ``job``, the
GPU-sized ``tpujob``, ``dask``, ``spark``, ``databricks``) and the ones
the service deploys (``serving``, ``remote``, ``application``)."""

from __future__ import annotations

from ..common.runtimes_constants import RuntimeKinds  # noqa: F401
from .base import BaseRuntime, FunctionMetadata, FunctionSpec, FunctionStatus  # noqa: F401
from .generators import get_generator  # noqa: F401
from .local import HandlerRuntime, LocalRuntime  # noqa: F401


def _registry() -> dict:
    from .daskjob import DaskRuntime
    from .databricks import DatabricksRuntime
    from .kubejob import KubejobRuntime
    from .remote import ApplicationRuntime, RemoteRuntime
    from .serving import ServingRuntime
    from .sparkjob import SparkRuntime
    from .tpujob import TpuJobRuntime

    return {
        RuntimeKinds.local: LocalRuntime,
        "": LocalRuntime,
        RuntimeKinds.handler: HandlerRuntime,
        RuntimeKinds.job: KubejobRuntime,
        RuntimeKinds.tpujob: TpuJobRuntime,
        RuntimeKinds.dask: DaskRuntime,
        RuntimeKinds.spark: SparkRuntime,
        RuntimeKinds.databricks: DatabricksRuntime,
        RuntimeKinds.serving: ServingRuntime,
        RuntimeKinds.remote: RemoteRuntime,
        RuntimeKinds.application: ApplicationRuntime,
    }


def get_runtime_class(kind: str) -> type:
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
