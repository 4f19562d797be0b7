"""Datastore profile schemas (reference analog:
mlrun/common/schemas/datastore_profile.py)."""

from __future__ import annotations

from typing import Optional

import pydantic


class DatastoreProfile(pydantic.BaseModel):
    """Public (non-secret) half of a profile; the private half rides the
    project secret store (datastore/profiles.py)."""

    name: str
    type: str = "basic"
    fields: dict = {}
    project: Optional[str] = None


class DatastoreProfileCreate(pydantic.BaseModel):
    profile: DatastoreProfile
    private: Optional[dict] = None
