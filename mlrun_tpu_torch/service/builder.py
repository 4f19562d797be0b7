"""Server-side image and requirements builder — the port's copy of
``mlrun_tpu/service/builder.py``.

On a Kubernetes cluster a build bakes a new image with a Kaniko pod
(``make_dockerfile``, ``make_kaniko_pod``). With the local provider it
pre-warms the requirements overlay cache (``utils/bootstrap.py``) as a
background task whose pip output is the retrievable build log; runs of
the function bootstrap onto that overlay at pod start.
"""

from __future__ import annotations

import io
import threading
import time

from ..config import K8S_DEFAULTS, run_config
from ..utils import get_in, logger, update_in
from ..utils.bootstrap import ensure_overlay

BUILD_UID_PREFIX = "build-"


def _strip_image_tag(image: str) -> str:
    """Drop the tag (and any ``@sha256:...`` digest) from an image ref —
    but only a real tag: a ':' in ``registry:5000/repo`` belongs to the
    registry port, not a tag. Digest-pinned refs like ``repo@sha256:abc``
    or ``repo:tag@sha256:abc`` reduce to plain ``repo``."""
    head, _, last = image.rpartition("/")
    last = last.split("@", 1)[0]
    if ":" in last:
        last = last.rsplit(":", 1)[0]
    return f"{head}/{last}" if head else last


def make_dockerfile(base_image: str, requirements: list[str] | None = None,
                    commands: list[str] | None = None,
                    source: str = "", workdir: str = "/app") -> str:
    """Dockerfile text for a function image: python deps layered over a
    prebuilt base image."""
    lines = [f"FROM {base_image}"]
    if source:
        lines += [f"WORKDIR {workdir}", f"ADD {source} {workdir}"]
    for command in commands or []:
        lines.append(f"RUN {command}")
    if requirements:
        lines.append("COPY requirements.txt /tmp/mlt-requirements.txt")
        lines.append(
            "RUN python -m pip install --no-cache-dir "
            "-r /tmp/mlt-requirements.txt")
    return "\n".join(lines) + "\n"


def make_kaniko_pod(project: str, name: str, dockerfile: str,
                    dest_image: str, context_path: str = "",
                    registry_secret: str = "") -> dict:
    """Kaniko builder pod manifest. An init container writes the
    dockerfile from an env var, so the manifest is self-contained."""
    build_name = f"mlt-build-{project}-{name}-{int(time.time())}"[:63]
    kaniko_args = [
        "--dockerfile=/workspace/Dockerfile",
        f"--destination={dest_image}",
        "--context=dir:///workspace",
    ]
    volumes = [{"name": "workspace", "emptyDir": {}}]
    volume_mounts = [{"name": "workspace", "mountPath": "/workspace"}]
    if registry_secret:
        volumes.append({"name": "registry-creds", "secret": {
            "secretName": registry_secret}})
        volume_mounts.append({"name": "registry-creds",
                              "mountPath": "/kaniko/.docker"})
    # the dockerfile is written by an init container from an env var, so
    # no ConfigMap round-trip is needed
    init = {
        "name": "write-dockerfile",
        "image": "busybox",
        "command": ["sh", "-c",
                    "printf '%s' \"$DOCKERFILE\" > /workspace/Dockerfile; "
                    "printf '%s' \"$REQUIREMENTS\" > "
                    "/workspace/requirements.txt"],
        "env": [{"name": "DOCKERFILE", "value": dockerfile},
                {"name": "REQUIREMENTS", "value": ""}],
        "volumeMounts": [{"name": "workspace", "mountPath": "/workspace"}],
    }
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": build_name,
            "namespace": K8S_DEFAULTS["namespace"],
            "labels": {"mlrun-tpu/class": "build",
                       "mlrun-tpu/project": project,
                       "mlrun-tpu/function": name},
        },
        "spec": {
            "initContainers": [init],
            "containers": [{
                "name": "kaniko",
                "image": "gcr.io/kaniko-project/executor:latest",
                "args": kaniko_args,
                "volumeMounts": volume_mounts,
            }],
            "volumes": volumes,
            "restartPolicy": "Never",
        },
    }


class _DbLogWriter(io.TextIOBase):
    """File-like adapter that appends lines to the run-log store so the
    build log is retrievable over `/build/status`."""

    def __init__(self, db, uid: str, project: str):
        self._db = db
        self._uid = uid
        self._project = project

    def write(self, text: str):  # type: ignore[override]
        if text:
            self._db.store_log(self._uid, self._project, text.encode())
        return len(text)

    def flush(self):
        pass


class FunctionBuilder:
    """Runs function builds and tracks them as background tasks."""

    def __init__(self, db, provider):
        self.db = db
        self.provider = provider

    def build(self, function: dict, with_gpu: bool = False) -> dict:
        """Resolve the image and, when the build spec asks for more than a
        prebuilt image (requirements/commands), run the build. Returns the
        function status dict; long builds continue in a background task.
        ``with_gpu`` bases the image on the GPU image
        (``K8S_DEFAULTS["image"]``) instead of the default one."""
        name = get_in(function, "metadata.name", "fn")
        project = get_in(function, "metadata.project",
                         run_config("default_project"))
        tag = get_in(function, "metadata.tag", "latest") or "latest"
        requirements = list(get_in(function, "spec.build.requirements",
                                   []) or [])
        commands = list(get_in(function, "spec.build.commands", []) or [])
        base_image = get_in(function, "spec.build.base_image", "") or (
            K8S_DEFAULTS["image"] if with_gpu
            else run_config("default_image"))
        image = get_in(function, "spec.image", "") or \
            get_in(function, "spec.build.image", "") or base_image

        update_in(function, "spec.image", image)
        if not requirements and not commands:
            # prebuilt image + code-in-env: nothing to bake
            update_in(function, "status.state", "ready")
            self.db.store_function(function, name, project, tag=tag)
            return {"state": "ready", "image": image,
                    "background_task": ""}

        task_name = f"{BUILD_UID_PREFIX}{name}-{int(time.time())}"
        log_uid = f"{BUILD_UID_PREFIX}{name}"
        update_in(function, "status.state", "deploying")
        update_in(function, "status.build_log_uid", log_uid)
        self.db.store_function(function, name, project, tag=tag)
        self.db.store_background_task(task_name, "running", project)

        if self.provider.kind == "kubernetes":
            target = self._build_kaniko
            # a kaniko build produces a NEW image the runs must use
            dest = get_in(function, "spec.build.image", "") or \
                f"{_strip_image_tag(image)}-{name}:{tag}"
            update_in(function, "spec.image", dest)
            args = (function, name, project, tag, task_name, log_uid,
                    base_image, requirements, commands, dest)
        else:
            target = self._build_overlay
            args = (function, name, project, tag, task_name, log_uid,
                    requirements, commands)
        thread = threading.Thread(target=target, args=args, daemon=True)
        thread.start()
        return {"state": "deploying", "image":
                get_in(function, "spec.image", image),
                "background_task": task_name}

    # -- local: pre-warm the bootstrap overlay cache -----------------------
    def _build_overlay(self, function: dict, name: str, project: str,
                       tag: str, task_name: str, log_uid: str,
                       requirements: list, commands: list):
        log = _DbLogWriter(self.db, log_uid, project)
        error = ""
        try:
            if commands:
                # the overlay path cannot honor docker RUN commands — a
                # build that silently drops them would "succeed" while
                # producing an image missing what the user asked for, so
                # it FAILS loudly instead (use the kubernetes provider's
                # kaniko path for command-bearing builds)
                raise RuntimeError(
                    "build commands require an image build; the local "
                    "provider's overlay path installs requirements only. "
                    f"unsupported commands: {commands}")
            ensure_overlay(requirements, log_fp=log)
            state = "ready"
            log.write("build completed\n")
        except Exception as exc:  # noqa: BLE001
            state = "error"
            error = str(exc)
            log.write(f"build failed: {exc}\n")
            logger.warning("function build failed", function=name,
                           error=str(exc))
        self._finish(function, name, project, tag, task_name, state,
                     error=error)

    # -- kubernetes: kaniko pod --------------------------------------------
    def _build_kaniko(self, function: dict, name: str, project: str,
                      tag: str, task_name: str, log_uid: str,
                      base_image: str, requirements: list, commands: list,
                      dest_image: str):
        log = _DbLogWriter(self.db, log_uid, project)
        error = ""
        try:
            dockerfile = make_dockerfile(base_image, requirements, commands)
            pod = make_kaniko_pod(project, name, dockerfile, dest_image)
            pod["spec"]["initContainers"][0]["env"][1]["value"] = \
                "\n".join(requirements)
            resource_id = self.provider.create(pod, f"build-{name}")
            log.write(f"kaniko pod created: {resource_id}\n")
            deadline = time.time() + 1800
            state = "error"
            error = "kaniko build timed out"
            while time.time() < deadline:
                phase = self.provider.state(resource_id)
                if phase == "Succeeded":
                    state, error = "ready", ""
                    break
                if phase == "Failed":
                    error = "kaniko pod failed"
                    break
                time.sleep(2.0)
            log.write(f"kaniko pod finished: {state}\n")
            try:
                self.provider.delete(resource_id)
            except Exception:  # noqa: BLE001
                pass
        except Exception as exc:  # noqa: BLE001
            state = "error"
            error = str(exc)
            log.write(f"build failed: {exc}\n")
        self._finish(function, name, project, tag, task_name, state,
                     error=error)

    def _finish(self, function: dict, name: str, project: str, tag: str,
                task_name: str, state: str, error: str = ""):
        update_in(function, "status.state", state)
        if error:
            update_in(function, "status.error", error)
        self.db.store_function(function, name, project, tag=tag)
        self.db.store_background_task(
            task_name, "succeeded" if state == "ready" else "failed",
            project)

    # -- status ------------------------------------------------------------
    def status(self, name: str, project: str, tag: str = "latest",
               offset: int = 0) -> dict:
        from ..db.base import RunDBError

        try:
            function = self.db.get_function(name, project,
                                            tag=tag or "latest")
        except RunDBError:
            # the run db raises for a missing function: the route answers
            # 404 (the reference's lets it through as a 500)
            function = None
        if not function:
            return {"state": "not_found", "log": "", "offset": offset}
        state = get_in(function, "status.state", "unknown")
        log_uid = get_in(function, "status.build_log_uid", "")
        text, nbytes = "", 0
        if log_uid:
            try:
                _, data = self.db.get_log(log_uid, project, offset=offset)
                nbytes = len(data)  # offsets are BYTE positions — advance
                # by the raw length, not the decoded char count, or
                # multi-byte pip output re-reads and tears codepoints
                text = data.decode(errors="replace")
            except Exception:  # noqa: BLE001
                text, nbytes = "", 0
        return {"state": state, "log": text, "offset": offset + nbytes,
                "image": get_in(function, "spec.image", "")}
