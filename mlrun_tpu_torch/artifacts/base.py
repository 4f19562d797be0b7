"""The artifact model — the port's copy of ``mlrun_tpu/artifacts/base.py``
(``Artifact``, its metadata / spec / status, ``LinkArtifact``, target-path
generation and the upload of a body, a file or a directory tree)."""

from __future__ import annotations

import hashlib
import os
import pathlib

from ..model import ModelObj


class ArtifactMetadata(ModelObj):
    _dict_fields = ["key", "project", "iter", "tree", "tag", "labels",
                    "annotations", "created", "updated", "uid"]

    def __init__(self, key=None, project=None, iter=None, tree=None, tag=None,
                 labels=None, annotations=None, created=None, updated=None,
                 uid=None):
        self.key = key
        self.project = project
        self.iter = iter or 0
        self.tree = tree  # producer id (run uid)
        self.tag = tag
        self.labels = labels or {}
        self.annotations = annotations or {}
        self.created = created
        self.updated = updated
        self.uid = uid


class ArtifactSpec(ModelObj):
    _dict_fields = ["src_path", "target_path", "viewer", "format", "size", "db_key",
                    "extra_data", "unpackaging_instructions", "producer", "hash"]

    def __init__(self, src_path=None, target_path=None, viewer=None, format=None,
                 size=None, db_key=None, extra_data=None,
                 unpackaging_instructions=None, producer=None, hash=None):
        self.src_path = src_path
        self.target_path = target_path
        self.viewer = viewer
        self.format = format
        self.size = size
        self.db_key = db_key
        self.extra_data = extra_data or {}
        self.unpackaging_instructions = unpackaging_instructions
        self.producer = producer
        self.hash = hash


class ArtifactStatus(ModelObj):
    _dict_fields = ["state", "stats"]

    def __init__(self, state="created", stats=None):
        self.state = state
        self.stats = stats


def upload_directory(target: str, src_dir: str) -> tuple[int, str]:
    """Upload a local directory tree file-by-file under a target prefix
    (shared by base/model artifacts). Returns (total_size, tree_hash) —
    the hash digests sorted (relpath, file_sha1) pairs so identical trees
    compare equal."""
    from ..datastore import store_manager

    store, prefix = store_manager.get_or_create_store(target)
    prefix = prefix.rstrip("/")
    total = 0
    digest = hashlib.sha1()
    entries = []
    for root, _, files in os.walk(src_dir):
        for name in files:
            full = os.path.join(root, name)
            rel = os.path.relpath(full, src_dir)
            entries.append((rel, full))
    for rel, full in sorted(entries):
        store.upload(f"{prefix}/{rel}", full)
        total += os.path.getsize(full)
        with open(full, "rb") as fp:
            digest.update(rel.encode())
            digest.update(hashlib.sha1(fp.read()).digest())
    return total, digest.hexdigest()


class Artifact(ModelObj):
    kind = "artifact"
    _dict_fields = ["kind", "metadata", "spec", "status"]
    _nested_fields = {"metadata": ArtifactMetadata, "spec": ArtifactSpec,
                      "status": ArtifactStatus}
    _store_prefix = "artifacts"

    def __init__(self, key=None, body=None, local_path=None, target_path=None,
                 viewer=None, format=None, project=None, metadata=None, spec=None,
                 status=None):
        self.metadata = metadata or ArtifactMetadata(key=key, project=project)
        self.spec = spec or ArtifactSpec(src_path=local_path,
                                         target_path=target_path,
                                         viewer=viewer, format=format)
        self.status = status or ArtifactStatus()
        self._body = body

    # convenience accessors
    @property
    def key(self):
        return self.metadata.key

    @property
    def target_path(self):
        return self.spec.target_path

    @target_path.setter
    def target_path(self, value):
        self.spec.target_path = value

    @property
    def uri(self) -> str:
        uri = f"store://{self._store_prefix}/{self.metadata.project}/{self.metadata.key}"
        if self.metadata.tag:
            uri += f":{self.metadata.tag}"
        if self.metadata.tree:
            uri += f"@{self.metadata.tree}"
        return uri

    def get_body(self):
        return self._body

    def before_log(self):
        """Hook for subtypes to finalize spec before upload/registration."""

    def generate_target_path(self, artifact_path: str, producer=None) -> str:
        """The target path under the run's artifact path."""
        suffix = ""
        if self.spec.src_path:
            suffix = pathlib.Path(self.spec.src_path).suffix
        elif self.spec.format:
            suffix = f".{self.spec.format}"
        version = self.metadata.tree or "0"
        return os.path.join(
            artifact_path, f"{self.metadata.key}{('-' + version[:8]) if version else ''}{suffix}"
        ).replace("\\", "/")

    def upload(self, data_item_factory=None):
        """Write body or src file to target_path via the datastore layer."""
        from ..datastore import store_manager

        target = self.spec.target_path
        if not target:
            raise ValueError(f"artifact {self.key} has no target_path")
        body = self.get_body()
        if body is not None:
            if isinstance(body, (dict, list)):
                import json

                body = json.dumps(body, default=str)
            store, path = store_manager.get_or_create_store(target)
            store.put(path, body)
            raw = body.encode() if isinstance(body, str) else body
            self.spec.size = len(raw)
            self.spec.hash = hashlib.sha1(raw).hexdigest()
        elif self.spec.src_path and os.path.isfile(self.spec.src_path):
            store, path = store_manager.get_or_create_store(target)
            store.upload(path, self.spec.src_path)
            self.spec.size = os.path.getsize(self.spec.src_path)
            with open(self.spec.src_path, "rb") as fp:
                self.spec.hash = hashlib.sha1(fp.read()).hexdigest()
        elif self.spec.src_path and os.path.isdir(self.spec.src_path):
            # directory artifacts (tensorboard logs, checkpoints): upload
            # the tree file by file under the target prefix
            self.spec.size, self.spec.hash = upload_directory(
                target, self.spec.src_path)

    def to_dataitem(self):
        from ..datastore import store_manager

        return store_manager.object(url=self.spec.target_path, key=self.key)


class LinkArtifact(Artifact):
    """Points the parent key at a best-iteration child."""

    kind = "link"
    _dict_fields = Artifact._dict_fields

    def __init__(self, key=None, link_iteration=None, link_key=None,
                 link_tree=None, **kwargs):
        super().__init__(key, **kwargs)
        self.spec.extra_data = {
            "link_iteration": link_iteration,
            "link_key": link_key,
            "link_tree": link_tree,
        }
