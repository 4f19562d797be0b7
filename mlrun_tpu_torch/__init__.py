"""mlrun_tpu_torch — the PyTorch/CUDA port of mlrun_tpu for NVIDIA H100.

Mirrors the structure of ``mlrun_tpu/`` module for module. It imports
``torch`` and never ``jax``, and nothing of ``mlrun_tpu``: what it needs of
the host-side modules it keeps as its own copies. Each Pallas kernel on a
ported path is a hand-written CUDA kernel under ``csrc/``, built at first
use (ops/_build.py), with a plain PyTorch version beside it.

The run stack is at the top level as in the reference: ``new_function``
(e.g. ``new_function("train", kind="tpujob").run(handler=train,
local=True)``), ``get_run_db`` and ``MLClientCtx``.
"""

__version__ = "0.1.0"

from .db import get_run_db  # noqa: E402,F401
from .execution import MLClientCtx  # noqa: E402,F401
from .run import new_function  # noqa: E402,F401
