"""Secret schemas (reference analog: mlrun/common/schemas/secret.py)."""

from __future__ import annotations

import enum
from typing import Optional

import pydantic


class SecretProviderName(str, enum.Enum):
    kubernetes = "kubernetes"
    vault = "vault"


class SecretsData(pydantic.BaseModel):
    provider: SecretProviderName = SecretProviderName.kubernetes
    secrets: dict[str, str] = {}


class SecretKeysData(pydantic.BaseModel):
    provider: SecretProviderName = SecretProviderName.kubernetes
    secret_keys: list[str] = []


class AuthSecretData(pydantic.BaseModel):
    provider: SecretProviderName = SecretProviderName.kubernetes
    username: Optional[str] = None
    access_key: Optional[str] = None
