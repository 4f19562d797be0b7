"""Kubernetes job runtime — the port's copy of
``mlrun_tpu/runtimes/kubejob.py`` (the client side; the service creates
the pod and builds the image)."""

from __future__ import annotations

from ..common.runtimes_constants import RuntimeKinds
from ..model import RunObject
from ..utils import logger
from .pod import KubeResource


class KubejobRuntime(KubeResource):
    kind = RuntimeKinds.job
    _is_remote = True

    @property
    def is_deployed(self) -> bool:
        """True when the function image exists."""
        if self.spec.image:
            return True
        build = self.spec.build
        return not (build and (build.source or build.commands
                               or build.requirements))

    def build_config(self, image: str = "", base_image: str = "",
                     commands: list | None = None, requirements: list | None = None,
                     source: str = ""):
        build = self.spec.build
        build.image = image or build.image
        build.base_image = base_image or build.base_image
        if commands:
            build.commands = (build.commands or []) + list(commands)
        if requirements:
            build.requirements = (build.requirements or []) + list(requirements)
        build.source = source or build.source
        return self

    def deploy(self, watch: bool = True, with_gpu: bool = False,
               skip_deployed: bool = False) -> bool:
        """Request a build from the service (its ``service/builder.py``: a
        pre-warm of the requirements overlay locally, a Kaniko pod on
        kubernetes); ``with_gpu`` bases the image on the GPU image. With
        ``watch`` the call follows ``/build/status``, printing the build
        log, until the build ends. True when the image is ready."""
        if skip_deployed and self.is_deployed:
            return True
        db = self._get_db()
        resp = db.remote_builder(self, with_gpu=with_gpu)
        status = resp.get("data", {}).get("status", {})
        self.spec.image = status.get("image") or self.spec.image
        state = status.get("state", "ready")
        if watch and state == "deploying":
            state = self._watch_build(db)
        logger.info("function build finished", image=self.spec.image,
                    state=state)
        return state == "ready"

    def _watch_build(self, db, timeout: float = 1800.0) -> str:
        import sys
        import time

        offset = 0
        deadline = time.time() + timeout
        state = "deploying"
        while time.time() < deadline:
            resp = db.get_builder_status(self, offset=offset)
            data = resp.get("data", resp) if isinstance(resp, dict) else {}
            log = data.get("log", "")
            if log:
                sys.stdout.write(log)
                sys.stdout.flush()
            offset = data.get("offset", offset)
            state = data.get("state", state)
            if state in ("ready", "error"):
                self.spec.image = data.get("image") or self.spec.image
                return state
            time.sleep(1.0)
        return state

    def _run(self, runobj: RunObject, execution) -> dict:
        # runs happen server-side; reaching here means misconfiguration
        raise RuntimeError(
            "the job runtime executes on the cluster — configure MLT_DBPATH "
            "to point at the service, or pass local=True to run in-process")
