"""The no-op run db (``dbpath`` "nop") — the port's copy of
``mlrun_tpu/db/nopdb.py``."""

from __future__ import annotations

from ..utils.logger import logger
from .base import RunDBInterface


class NopDB(RunDBInterface):
    kind = "nop"

    def __init__(self, url: str = ""):
        self.url = url
        self._warned = False

    def _warn(self):
        if not self._warned:
            logger.warning(
                "no run db configured — results will not be persisted "
                "(set MLT_DBPATH or use the default local sqlite db)")
            self._warned = True

    def store_run(self, struct, uid, project="", iter=0):
        self._warn()

    def update_run(self, updates, uid, project="", iter=0):
        self._warn()

    def read_run(self, uid, project="", iter=0):
        self._warn()
        return {}

    def list_runs(self, *args, **kwargs):
        return []

    def del_run(self, uid, project="", iter=0):
        pass

    def store_log(self, uid, project="", body=b"", append=True):
        pass

    def get_log(self, uid, project="", offset=0, size=-1):
        return "unknown", b""

    def store_artifact(self, key, artifact, uid=None, iter=None, tag="",
                       project="", tree=None):
        self._warn()

    def read_artifact(self, key, tag=None, iter=None, project="", tree=None,
                      uid=None):
        self._warn()
        return {}

    def list_artifacts(self, *args, **kwargs):
        return []

    def del_artifact(self, key, tag=None, project="", uid=None):
        pass

    def store_function(self, function, name, project="", tag="", versioned=False):
        self._warn()
        return ""

    def get_function(self, name, project="", tag="", hash_key=""):
        self._warn()
        return {}

    def list_functions(self, *args, **kwargs):
        return []

    def delete_function(self, name, project=""):
        pass

    def store_project(self, name, project):
        self._warn()
        return project

    def get_project(self, name):
        return None

    def list_projects(self, *args, **kwargs):
        return []

    def delete_project(self, name, deletion_strategy="restricted"):
        pass
