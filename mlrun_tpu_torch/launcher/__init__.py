"""Launchers — the port's copy of ``mlrun_tpu/launcher``: the local
launcher runs a task in this process; the remote launcher stores the
function in the service and submits the run over HTTP."""

from .base import BaseLauncher  # noqa: F401
from .factory import LauncherFactory  # noqa: F401
from .local import ClientLocalLauncher  # noqa: F401
from .remote import ClientRemoteLauncher  # noqa: F401
