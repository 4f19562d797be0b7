"""Handler packaging — the port's copy of ``mlrun_tpu/package``: the
packagers manager with the standard-library, numpy, pandas and torch
families, the context handler over a duck-typed context, and the
reference package's top-level ``handler`` decorator and
``ArtifactType`` log hints."""

from .context_handler import ContextHandler  # noqa: F401
from .packagers_manager import Packager, PackagersManager  # noqa: F401


class ArtifactType:
    """Log-hint artifact types."""

    result = "result"
    artifact = "artifact"
    dataset = "dataset"
    model = "model"
    file = "file"
    plot = "plot"


def handler(labels: dict | None = None, outputs: list | None = None,
            inputs: bool = True):
    """Decorator marking a function as a handler with packaging hints."""

    def decorator(func):
        setattr(func, "_mlt_handler", {
            "labels": labels, "outputs": outputs, "inputs": inputs})
        return func

    return decorator
