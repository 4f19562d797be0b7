"""Requirements bootstrap — the runtime half of the image-build story;
the port's copy of ``mlrun_tpu/utils/bootstrap.py``.

Reference analog: `server/api/utils/builder.py:39` bakes requirements into
an image with Kaniko. On GPU clusters the base images are prebuilt and
code rides the env (`MLT_EXEC_CODE`), so extra *python* requirements are
satisfied at pod start instead: pip installs them ONCE into a cached
overlay directory keyed by the requirements hash
(``pip install --target``), and the run command re-execs with that overlay
prepended to ``PYTHONPATH``. An overlay (not a venv) because the runtime
image's interpreter is often itself a venv — chaining venvs would lose the
preinstalled torch/CUDA stack, while an overlay strictly adds to it.

The service's builder (`service/builder.py`) takes the Kaniko path on a
Kubernetes cluster; this module is the zero-registry route that works
anywhere a pod can run pip (the builder's local path pre-warms its
overlay).
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import time

from ..config import home_dir
from . import logger


def requirements_hash(requirements: list[str], extra: str = "") -> str:
    """Stable cache key for a requirements set (order-insensitive)."""
    blob = "\n".join(sorted(requirements)) + "\n" + extra
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def default_overlay_root() -> str:
    return os.path.join(home_dir(), "pkg-overlays")


def ensure_overlay(requirements: list[str], overlay_root: str | None = None,
                   log_fp=None, timeout: float = 600.0) -> str:
    """Create (or reuse) the cached overlay dir for ``requirements`` and
    return its path. Concurrent callers racing on the same hash serialize
    on ``flock(2)`` over a sidecar lock file: the kernel drops the lock
    the instant its owner dies — even SIGKILLed mid-pip — so there is no
    pid bookkeeping, no stale-lock reclaim, and no dead-check/takeover
    race (ADVICE r3/r4: the previous mkdir+pid-file scheme could not
    close that race). The timeout is a single fixed deadline: waiters
    poll for the winner's ``.ready`` marker and give up when it passes,
    regardless of how many owners come and go in between."""
    import fcntl

    overlay_root = overlay_root or default_overlay_root()
    os.makedirs(overlay_root, exist_ok=True)
    key = requirements_hash(requirements)
    overlay = os.path.join(overlay_root, key)
    ready = os.path.join(overlay, ".ready")
    if os.path.exists(ready):
        return overlay

    def log(line: str):
        if log_fp is not None:
            log_fp.write(line if line.endswith("\n") else line + "\n")
            log_fp.flush()

    deadline = time.time() + timeout
    fd = os.open(overlay + ".lock", os.O_CREAT | os.O_RDWR, 0o644)
    try:
        while True:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
                break
            except OSError:
                if os.path.exists(ready):
                    return overlay
                if time.time() >= deadline:
                    raise TimeoutError(
                        f"requirements install for {key} did not finish "
                        f"within {timeout}s")
                time.sleep(0.25)
        # lock held; the previous owner may have finished while we waited
        if os.path.exists(ready):
            return overlay
        log(f"installing {len(requirements)} requirement(s) into {overlay}")
        cmd = [sys.executable, "-m", "pip", "install",
               "--target", overlay, "--no-warn-script-location",
               "--disable-pip-version-check", *requirements]
        log("$ " + " ".join(cmd))
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        for line in proc.stdout:
            log(line)
        code = proc.wait()
        if code != 0:
            raise RuntimeError(
                f"pip install failed with exit code {code} (requirements: "
                f"{requirements})")
        with open(ready, "w") as fp:
            fp.write("\n".join(requirements) + "\n")
        log(f"requirements overlay ready: {overlay}")
        return overlay
    finally:
        os.close(fd)


def exec_with_requirements(requirements: list[str], command: list[str],
                           overlay_root: str | None = None, log_fp=None):
    """Replace this process with ``command`` running with the cached
    requirements overlay on PYTHONPATH (the in-pod `python3 -m
    mlrun_tpu_torch bootstrap` contract)."""
    overlay = ensure_overlay(requirements, overlay_root,
                             log_fp if log_fp is not None else sys.stderr)
    if not command:
        return overlay
    argv = list(command)
    if argv[0] in ("mlrun-tpu", "mlrun_tpu", "mlrun-tpu-torch"):
        argv = [sys.executable, "-m", "mlrun_tpu_torch"] + argv[1:]
    elif argv[0] in ("python", "python3"):
        argv = [sys.executable] + argv[1:]
    env = os.environ.copy()
    existing = env.get("PYTHONPATH", "")
    env["PYTHONPATH"] = overlay + (os.pathsep + existing if existing
                                   else "")
    # overlay console scripts (pip --target puts them in bin/)
    bin_dir = os.path.join(overlay, "bin")
    if os.path.isdir(bin_dir):
        env["PATH"] = bin_dir + os.pathsep + env.get("PATH", "")
    logger.info("bootstrap exec", command=argv[0], overlay=overlay)
    # execvPe: PATH lookup so wrapped entrypoints like `bash` resolve
    # (including console scripts from the overlay's bin/ just prepended)
    os.execvpe(argv[0], argv, env)
