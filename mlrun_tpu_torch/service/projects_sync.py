"""Projects leader/follower sync — the port's copy of
``mlrun_tpu/service/projects_sync.py``.

Reference analog: server/api/utils/projects/leader.py:42 (Member owning the
project lifecycle) and follower.py:46 (periodic ``_sync_projects`` pulling
the leader's project list and reconciling the local store). Here any
mlrun-tpu service acts as leader by default; pointing
``projects.leader_url`` (``config.SERVICE_DEFAULTS``, env
``MLT_PROJECTS__LEADER_URL``) at another service turns this instance into
a follower: the sync loop upserts the leader's projects into the local DB
and archives local projects the leader no longer has, while project
mutations are forwarded leader-first.
"""

from __future__ import annotations

from ..config import run_config, service_config
from ..utils import logger


class ProjectsFollower:
    def __init__(self, db, leader_url: str = ""):
        self.db = db
        self.leader_url = leader_url or service_config("projects.leader_url")
        self._leader_db = None

    @property
    def enabled(self) -> bool:
        return bool(self.leader_url)

    def _leader(self):
        if self._leader_db is None:
            from ..db.httpdb import HTTPRunDB

            self._leader_db = HTTPRunDB(self.leader_url)
        return self._leader_db

    def forward_store(self, name: str, project: dict) -> dict:
        """Leader-first create/update (reference follower create flow)."""
        stored = self._leader().store_project(name, project)
        self.db.store_project(name, stored or project)
        return stored or project

    def forward_delete(self, name: str,
                       deletion_strategy: str = "restricted"):
        self._leader().delete_project(name,
                                      deletion_strategy=deletion_strategy)
        self.db.delete_project(name, deletion_strategy=deletion_strategy)

    def sync_once(self) -> dict:
        """One reconciliation pass; returns counters (for tests/ops)."""
        leader_projects = {p["metadata"]["name"]
                          if isinstance(p.get("metadata"), dict)
                          else p.get("name"): p
                          for p in self._leader().list_projects()}
        leader_projects.pop(None, None)
        local = {p.get("metadata", {}).get("name") or p.get("name"): p
                 for p in self.db.list_projects()}
        created = updated = archived = 0
        for name, project in leader_projects.items():
            if name not in local:
                self.db.store_project(name, project)
                created += 1
            elif local[name] != project:
                self.db.store_project(name, project)
                updated += 1
        for name, project in local.items():
            if name in leader_projects or \
                    name == run_config("default_project"):
                continue
            # the leader no longer has it → archive locally (never a hard
            # delete from a sync pass; reference archives on desync too)
            if not isinstance(project.get("status"), dict):
                project["status"] = {}
            if project["status"].get("state") != "archived":
                project["status"]["state"] = "archived"
                self.db.store_project(name, project)
                archived += 1
        return {"created": created, "updated": updated,
                "archived": archived}

    def sync_safe(self):
        try:
            counters = self.sync_once()
            if any(counters.values()):
                logger.info("projects synced from leader",
                            leader=self.leader_url, **counters)
        except Exception as exc:  # noqa: BLE001 - keep the loop alive
            logger.warning("projects sync failed", leader=self.leader_url,
                           error=str(exc))
