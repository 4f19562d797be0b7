"""Which process of a multi-process run logs — the port's counterpart of
``MLClientCtx.is_logging_worker`` (``mlrun_tpu/execution.py``).

The port has no run context class of its own: its entry points take a
duck-typed context (``log_metrics``, ``log_result(s)``, ``log_artifact``,
``log_model``, ...). When that context has no ``is_logging_worker``, the
callbacks, ``Trainer.fit`` and ``auto_trainer`` ask :func:`logging_worker`,
which falls back to :func:`is_logging_worker`.
"""

from __future__ import annotations

import os

# checked in order; the first one set decides. torchrun's RANK is the
# global rank of this process (one per GPU), so a pod running eight
# processes has one logger, not eight
RANK_ENVS = ("RANK", "MLT_WORKER_RANK")


def is_logging_worker() -> bool:
    """True on exactly one process of a multi-process run: global rank 0
    by torchrun's ``RANK``, else ``MLT_WORKER_RANK``, else the
    initialised ``torch.distributed`` group's rank; True in a lone
    process."""
    for env in RANK_ENVS:
        if env in os.environ:
            return os.environ[env].split(":")[0] in ("0", "")
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank() == 0
    except Exception:  # noqa: BLE001 - any backend issue: one process
        pass
    return True


def logging_worker(context) -> bool:
    """``context.is_logging_worker()`` when the context has it, else
    :func:`is_logging_worker`."""
    check = getattr(context, "is_logging_worker", None)
    return bool(check()) if callable(check) else is_logging_worker()
