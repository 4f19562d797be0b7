"""Kubernetes job runtime — the port's copy of
``mlrun_tpu/runtimes/kubejob.py`` (the client side; the service creates
the pod and builds the image, ROADMAP.md item 14)."""

from __future__ import annotations

from ..common.runtimes_constants import RuntimeKinds
from ..model import RunObject
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
        """Build the function's image through the service (its builder,
        ROADMAP.md item 14); True at once when ``skip_deployed`` and the
        image exists."""
        if skip_deployed and self.is_deployed:
            return True
        from ..serving.resilience import not_ported

        raise not_ported("the service's image builder (deploy, part 14c)", 14)

    def _run(self, runobj: RunObject, execution) -> dict:
        # runs happen server-side; reaching here means misconfiguration
        raise RuntimeError(
            "the job runtime executes on the cluster — configure MLT_DBPATH "
            "to point at the service, or pass local=True to run in-process")
