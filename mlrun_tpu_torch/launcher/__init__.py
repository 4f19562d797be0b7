"""Launchers — the port's copy of ``mlrun_tpu/launcher``: the local
launcher runs a task in this process; the remote launcher (a client of the
service) raises ``not_ported`` item 14."""

from .base import BaseLauncher  # noqa: F401
from .factory import LauncherFactory  # noqa: F401
from .local import ClientLocalLauncher  # noqa: F401
