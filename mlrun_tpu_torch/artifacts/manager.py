"""``ArtifactManager`` — the port's copy of ``mlrun_tpu/artifacts/manager.py``.

Owns the log-artifact flow: resolve target path → subtype before_log() →
upload → register in the run DB → record uri on the producing run.
"""

from __future__ import annotations

import os
from typing import Union

from ..utils.helpers import generate_uid, now_iso, template_artifact_path
from ..utils.logger import logger
from .base import Artifact, LinkArtifact
from .dataset import DatasetArtifact
from .model import ModelArtifact
from .plots import ChartArtifact, PlotArtifact, TableArtifact

artifact_types: dict[str, type] = {
    "": Artifact,
    "artifact": Artifact,
    "dataset": DatasetArtifact,
    "model": ModelArtifact,
    "plot": PlotArtifact,
    "chart": ChartArtifact,
    "table": TableArtifact,
    "link": LinkArtifact,
}


def dict_to_artifact(struct: dict) -> Artifact:
    kind = struct.get("kind", "")
    cls = artifact_types.get(kind, Artifact)
    return cls.from_dict(struct)


class ArtifactProducer:
    def __init__(self, kind: str, project: str, name: str, tag: str | None = None,
                 owner: str | None = None, uid: str | None = None):
        self.kind = kind
        self.project = project
        self.name = name
        self.tag = tag
        self.owner = owner
        self.uid = uid or generate_uid()
        self.inputs = {}

    def get_meta(self) -> dict:
        return {"kind": self.kind, "name": self.name, "tag": self.tag,
                "owner": self.owner, "uri": f"{self.project}/{self.uid}"}


class ArtifactManager:
    def __init__(self, db=None, calc_hash: bool = True):
        self.artifact_db = db
        self.calc_hash = calc_hash
        self.artifacts: dict[str, Artifact] = {}
        self.artifact_uris: dict[str, str] = {}

    def artifact_list(self, full: bool = False) -> list:
        return [a.to_dict() if full else {
            "key": a.key, "kind": a.kind, "uri": a.uri,
            "target_path": a.spec.target_path,
        } for a in self.artifacts.values()]

    def log_artifact(self, producer: ArtifactProducer,
                     item: Union[str, Artifact], body=None, target_path: str = "",
                     tag: str = "", viewer: str = "", local_path: str = "",
                     artifact_path: str | None = None, format: str | None = None,
                     upload: bool | None = None, labels: dict | None = None,
                     db_key: str | None = None, is_retained_producer=None,
                     unpackaging_instructions: dict | None = None,
                     **kwargs) -> Artifact:
        if isinstance(item, str):
            key = item
            if body is not None and not isinstance(body, (str, bytes, dict, list)):
                item = DatasetArtifact(key, df=body, format=format or "parquet")
            else:
                item = Artifact(key, body=body, viewer=viewer, format=format)
        else:
            key = item.key
            if body is not None:
                item._body = body

        meta = item.metadata
        meta.project = meta.project or producer.project
        meta.tree = meta.tree or producer.uid
        meta.tag = tag or meta.tag or "latest"
        meta.uid = meta.uid or generate_uid()
        meta.created = meta.created or now_iso()
        meta.updated = now_iso()
        if labels:
            meta.labels.update(labels)
        item.spec.src_path = local_path or item.spec.src_path
        item.spec.db_key = db_key or key
        item.spec.producer = producer.get_meta()
        if unpackaging_instructions:
            # stamped on the FIRST store (the packagers manager records
            # how to reconstruct the packed object without a type hint)
            item.spec.unpackaging_instructions = unpackaging_instructions

        item.before_log()

        if target_path:
            item.spec.target_path = target_path
        elif not item.spec.target_path:
            artifact_path = template_artifact_path(
                artifact_path or "", producer.project, producer.uid)
            if not artifact_path:
                from ..config import resolve_artifact_path

                artifact_path = resolve_artifact_path(producer.project)
            item.spec.target_path = item.generate_target_path(
                artifact_path, producer)

        model_file = getattr(item, "model_file", None)
        model_dir = getattr(item, "model_dir", None)
        should_upload = upload if upload is not None else (
            item.get_body() is not None
            or (item.spec.src_path
                and os.path.exists(item.spec.src_path))  # file OR directory
            # model artifacts carry their payload in model_file/model_dir,
            # not src_path — without this the model stays a dangling local
            # path and can never be served from another machine
            or (model_file and os.path.isfile(model_file))
            or (model_dir and os.path.isdir(model_dir))
        )
        if should_upload:
            try:
                item.upload()
            except Exception as exc:  # noqa: BLE001
                logger.warning("artifact upload failed", key=key, error=str(exc))

        item.status.state = "created"
        if self.artifact_db:
            self.artifact_db.store_artifact(
                item.spec.db_key, item.to_dict(), uid=meta.uid,
                iter=meta.iter, tag=meta.tag, project=meta.project,
                tree=meta.tree,
            )
        self.artifacts[key] = item
        self.artifact_uris[key] = item.uri
        return item

    def link_artifact(self, producer: ArtifactProducer, key: str,
                      iteration: int, link_key: str | None = None,
                      artifact_path: str = ""):
        link = LinkArtifact(
            key, link_iteration=iteration, link_key=link_key or key,
            link_tree=producer.uid,
        )
        link.metadata.project = producer.project
        link.metadata.tree = producer.uid
        link.spec.target_path = ""
        if self.artifact_db:
            self.artifact_db.store_artifact(
                key, link.to_dict(), uid=generate_uid(), iter=0,
                tag="latest", project=producer.project, tree=producer.uid,
            )
        return link
