"""Core object model — the port's copy of ``ModelObj``, the dict
round-trip base of ``mlrun_tpu/model.py``. The graph's steps and
``GraphServer`` inherit it, so a spec the reference serializes loads here
and serializes back to the same dict. The reference's run objects belong to
ROADMAP.md item 10."""

from __future__ import annotations

import json
from copy import deepcopy
from typing import Any


class ModelObj:
    """Dict-serializable base object.

    Subclasses list plain fields in ``_dict_fields`` and nested model
    fields in ``_nested_fields`` mapping name -> class (or None for a raw
    dict).
    """

    _dict_fields: list[str] = []
    _nested_fields: dict[str, type | None] = {}

    @staticmethod
    def _verify_list(param, name):
        if param is not None and not isinstance(param, list):
            raise ValueError(f"parameter {name} must be a list")

    @staticmethod
    def _verify_dict(param, name):
        if param is not None and not isinstance(param, dict):
            raise ValueError(f"parameter {name} must be a dict")

    def to_dict(self, exclude: list | None = None) -> dict:
        exclude = exclude or []
        out: dict[str, Any] = {}
        fields = self._dict_fields or [
            k for k in self.__dict__ if not k.startswith("_")
        ]
        for field in fields:
            if field in exclude:
                continue
            value = getattr(self, field, None)
            if value is None:
                continue
            if isinstance(value, ModelObj):
                value = value.to_dict()
            elif isinstance(value, list) and value \
                    and isinstance(value[0], ModelObj):
                value = [v.to_dict() for v in value]
            out[field] = value
        return out

    @classmethod
    def from_dict(cls, struct: dict | None = None,
                  deprecated_fields: dict | None = None):
        struct = struct or {}
        deprecated_fields = deprecated_fields or {}
        obj = cls()
        fields = cls._dict_fields or list(struct.keys())
        for field in fields:
            if field not in struct:
                continue
            value = struct[field]
            nested_cls = cls._nested_fields.get(field)
            if nested_cls is not None and isinstance(value, dict):
                value = nested_cls.from_dict(value)
            setattr(obj, field, value)
        for old, new in deprecated_fields.items():
            if old in struct and new:
                setattr(obj, new, struct[old])
        return obj

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), default=str)

    def to_yaml(self) -> str:
        import yaml

        return yaml.safe_dump(self.to_dict(), default_flow_style=False)

    def copy(self):
        return deepcopy(self)

    def __repr__(self):
        return f"{self.__class__.__name__}({self.to_dict()})"
