"""Persistent kernel-build cache — the port's counterpart of
``mlrun_tpu/utils/compile_cache.py``.

The port compiles no XLA programs; its one compile is the build of its
hand-written kernels (``ops/_build.py``): nvcc's ``libmlt_kernels.so`` and
g++'s host libraries, by default under ``build/`` inside the checkout,
which a pod's image may not let it write and which a restarted pod loses.
This module re-roots both build directories under
``training.compile_cache_dir`` (``COMPILE_CACHE_ENV`` overrides it, as the
reference's env layer maps that variable onto the same key), so a
restarted process — a resubmitted JobSet, a second ``Trainer.warmup()`` —
loads the libraries built there instead of running nvcc again. The build
key holds the toolkit's identity and the card's arch, so a directory
shared between images never serves a library built by another toolkit.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path

from ..config import COMPILE_CACHE_ENV  # noqa: F401
from .logger import logger

_lock = threading.Lock()
_configured_dir: str | None = None
_default_roots: tuple | None = None


def configured_dir() -> str | None:
    """The cache dir the kernel builds are rooted in (None = disabled)."""
    return _configured_dir


def _set_roots(kernels: Path, host: Path):
    from ..ops import _build

    global _default_roots
    if _default_roots is None:
        _default_roots = (_build.BUILD_ROOT, _build.HOST_BUILD_ROOT)
    _build.BUILD_ROOT = kernels
    _build.HOST_BUILD_ROOT = host
    if _build._state.lib is not None:
        # the loaded library stays for the process: swapping it under
        # running wrappers is never safe
        logger.info("kernel library already loaded — kept for this process",
                    lib=str(_build._state.lib_path))


def configure(cache_dir: str) -> str | None:
    """Root the kernel and host builds under ``cache_dir``
    (``<dir>/kernels/<hash>``, ``<dir>/host/<hash>``).

    Idempotent; re-pointing at a different dir is allowed (tests).
    Returns the resolved absolute dir, or None when ``cache_dir`` is empty
    (the builds stay where they are).
    """
    global _configured_dir

    if not cache_dir:
        return None
    cache_dir = os.path.abspath(os.path.expanduser(str(cache_dir)))
    with _lock:
        if _configured_dir == cache_dir:
            return cache_dir
        try:
            os.makedirs(cache_dir, exist_ok=True)
        except OSError as exc:  # an unwritable dir degrades to the
            # default build location, not a crash
            logger.warning("kernel build cache unavailable", dir=cache_dir,
                           error=str(exc))
            return None
        root = Path(cache_dir)
        _set_roots(root / "kernels", root / "host")
        _configured_dir = cache_dir
        logger.info("kernel build cache enabled", dir=cache_dir)
        return cache_dir


def disable():
    """Put the build roots back where they were (test isolation)."""
    global _configured_dir

    with _lock:
        if _configured_dir is None:
            return
        _set_roots(*_default_roots)
        _configured_dir = None


def configure_from_mlconf() -> str | None:
    """Wire the cache from ``COMPILE_CACHE_ENV``, else
    ``TRAINING_DEFAULTS["compile_cache_dir"]``. No-op when both are
    unset."""
    from ..config import TRAINING_DEFAULTS

    return configure(os.environ.get(COMPILE_CACHE_ENV)
                     or str(TRAINING_DEFAULTS.get("compile_cache_dir") or ""))
