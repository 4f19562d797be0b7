"""Datastore profiles — named connection configs addressable as
``ds://<profile>/<path>``; the port's copy of
``mlrun_tpu/datastore/profiles.py``. The PUBLIC part of a profile
(type, bucket, endpoint...) lives in the DB; the PRIVATE part (keys,
tokens) rides the project-secret store under
``mlrun.datastore-profiles.<name>`` and never crosses the REST list
surface.
"""

from __future__ import annotations

import json

PROFILE_SECRET_PREFIX = "mlrun.datastore-profiles."

_TEMP_PROFILES: dict[str, "DatastoreProfile"] = {}


class DatastoreProfile:
    """Base profile: subclasses declare which fields are private."""

    type = "basic"
    _private_fields: tuple = ()

    def __init__(self, name: str, **fields):
        self.name = name
        self.fields = fields

    # -- serialization ------------------------------------------------------
    def public_dict(self) -> dict:
        return {
            "name": self.name, "type": self.type,
            "fields": {k: v for k, v in self.fields.items()
                       if k not in self._private_fields},
        }

    def private_dict(self) -> dict:
        return {k: v for k, v in self.fields.items()
                if k in self._private_fields and v is not None}

    @staticmethod
    def from_parts(public: dict, private: dict | None = None
                   ) -> "DatastoreProfile":
        cls = _PROFILE_TYPES.get(public.get("type", "basic"),
                                 DatastoreProfile)
        fields = dict(public.get("fields") or {})
        fields.update(private or {})
        profile = cls(public["name"], **fields)
        return profile

    # -- resolution ---------------------------------------------------------
    def url(self, subpath: str) -> str:
        """The real datastore url for a ds:// subpath."""
        base = self.fields.get("url", "")
        if not base:
            raise ValueError(
                f"profile '{self.name}' has no url field")
        return base.rstrip("/") + ("/" + subpath.lstrip("/") if subpath
                                   else "")

    def secrets(self) -> dict:
        """Credential env-style secrets for the underlying store."""
        return {}


class DatastoreProfileBasic(DatastoreProfile):
    """Arbitrary url + private token (reference DatastoreProfileBasic)."""

    type = "basic"
    _private_fields = ("private",)


class DatastoreProfileS3(DatastoreProfile):
    type = "s3"
    _private_fields = ("access_key_id", "secret_key")

    def url(self, subpath: str) -> str:
        bucket = self.fields.get("bucket", "")
        prefix = f"s3://{bucket}" if bucket else "s3:/"
        return prefix + "/" + subpath.lstrip("/")

    def secrets(self) -> dict:
        out = {}
        if self.fields.get("access_key_id"):
            out["AWS_ACCESS_KEY_ID"] = self.fields["access_key_id"]
        if self.fields.get("secret_key"):
            out["AWS_SECRET_ACCESS_KEY"] = self.fields["secret_key"]
        if self.fields.get("endpoint_url"):
            out["S3_ENDPOINT_URL"] = self.fields["endpoint_url"]
        if self.fields.get("region"):
            out["AWS_REGION"] = self.fields["region"]
        return out


class DatastoreProfileGCS(DatastoreProfile):
    type = "gcs"
    _private_fields = ("credentials_json",)

    def url(self, subpath: str) -> str:
        bucket = self.fields.get("bucket", "")
        return f"gs://{bucket}/" + subpath.lstrip("/")

    def secrets(self) -> dict:
        out = {}
        if self.fields.get("credentials_json"):
            out["GCP_CREDENTIALS"] = self.fields["credentials_json"]
        if self.fields.get("credentials_path"):
            out["GOOGLE_APPLICATION_CREDENTIALS"] = \
                self.fields["credentials_path"]
        return out


class DatastoreProfileAzureBlob(DatastoreProfile):
    type = "az"
    _private_fields = ("connection_string", "account_key", "client_secret")

    def url(self, subpath: str) -> str:
        container = self.fields.get("container", "")
        return f"az://{container}/" + subpath.lstrip("/")

    def secrets(self) -> dict:
        out = {}
        for field, env in (("connection_string",
                            "AZURE_STORAGE_CONNECTION_STRING"),
                           ("account_name", "AZURE_STORAGE_ACCOUNT_NAME"),
                           ("account_key", "AZURE_STORAGE_ACCOUNT_KEY"),
                           ("client_id", "AZURE_STORAGE_CLIENT_ID"),
                           ("client_secret", "AZURE_STORAGE_CLIENT_SECRET"),
                           ("tenant_id", "AZURE_STORAGE_TENANT_ID")):
            if self.fields.get(field):
                out[env] = self.fields[field]
        return out


class DatastoreProfileRedis(DatastoreProfile):
    type = "redis"
    _private_fields = ("password",)

    def url(self, subpath: str) -> str:
        endpoint = self.fields.get("endpoint", "localhost:6379")
        return f"redis://{endpoint}/" + subpath.lstrip("/")

    def secrets(self) -> dict:
        out = {}
        if self.fields.get("username"):
            out["REDIS_USERNAME"] = self.fields["username"]
        if self.fields.get("password"):
            out["REDIS_PASSWORD"] = self.fields["password"]
        return out


_PROFILE_TYPES = {
    cls.type: cls for cls in
    (DatastoreProfileBasic, DatastoreProfileS3, DatastoreProfileGCS,
     DatastoreProfileAzureBlob, DatastoreProfileRedis)
}


def register_temporary_client_datastore_profile(profile: DatastoreProfile):
    """Client-side (process-local) registration — nothing leaves the
    process (reference function of the same name)."""
    _TEMP_PROFILES[profile.name] = profile


def remove_temporary_client_datastore_profile(name: str):
    _TEMP_PROFILES.pop(name, None)


def datastore_profile_read(name: str, project: str = "",
                           db=None) -> DatastoreProfile:
    """Resolve a profile: temporary client registry first, then the DB
    (+ project secrets for the private part when the db exposes them)."""
    profile = _TEMP_PROFILES.get(name)
    if profile is not None:
        return profile
    if db is None:
        from ..db import get_run_db

        try:
            db = get_run_db()
        except Exception as exc:  # noqa: BLE001 - no db configured
            raise ValueError(
                f"datastore profile '{name}' not registered client-side "
                f"and no run db is configured ({exc})") from exc
    getter = getattr(db, "get_datastore_profile", None)
    if getter is None:
        raise ValueError(
            f"datastore profile '{name}' not registered client-side and "
            "the db cannot resolve profiles")
    public = getter(name, project=project)
    if not public:
        raise ValueError(f"datastore profile '{name}' not found")
    private: dict = {}
    secret_getter = getattr(db, "get_project_secrets", None)
    if secret_getter is not None:
        # server-side: private part straight from the secret store
        raw = secret_getter(project,
                            keys=[PROFILE_SECRET_PREFIX + name])
        blob = raw.get(PROFILE_SECRET_PREFIX + name)
        if blob:
            private = json.loads(blob)
    else:
        # in-run: the secret was injected into the resource env as
        # MLT_SECRET_<key> by the runtime handler
        import os

        blob = os.environ.get(
            "MLT_SECRET_" + PROFILE_SECRET_PREFIX + name)
        if blob:
            private = json.loads(blob)
    return DatastoreProfile.from_parts(public, private)
