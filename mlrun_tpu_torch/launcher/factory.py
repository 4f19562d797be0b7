"""Launcher factory — the port's copy of ``mlrun_tpu/launcher/factory.py``."""

from __future__ import annotations

from ..config import run_config
from .base import BaseLauncher
from .local import ClientLocalLauncher
from .remote import ClientRemoteLauncher


class LauncherFactory:
    _server_side_cls = None  # the service injects its launcher here

    @classmethod
    def set_server_side(cls, launcher_cls):
        cls._server_side_cls = launcher_cls

    @classmethod
    def create_launcher(cls, is_remote: bool = False, local: bool = False,
                        is_api: bool = False, **kwargs) -> BaseLauncher:
        if is_api and cls._server_side_cls is not None:
            return cls._server_side_cls(**kwargs)
        if local:
            return ClientLocalLauncher(local=True)
        if is_remote:
            if not run_config("dbpath"):
                raise RuntimeError(
                    "remote runtime kinds need the service — set MLT_DBPATH "
                    "to the api url, or pass local=True to run in-process")
            return ClientRemoteLauncher()
        return ClientLocalLauncher(local=False)
