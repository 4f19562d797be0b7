"""Handler packaging — the port's copy of ``mlrun_tpu/package``: the
packagers manager with the standard-library, numpy, pandas and torch
families, and the context handler over a duck-typed context."""

from .context_handler import ContextHandler  # noqa: F401
from .packagers_manager import Packager, PackagersManager  # noqa: F401
