"""Standard-library packagers — the port's copy of
``mlrun_tpu/package/packagers/python_standard_library.py`` (int / float /
str / bool / bytes / collections / pathlib / dataclasses / datetime)."""

from __future__ import annotations

import datetime
import json
import pathlib

from .default import DefaultPackager


class PrimitivePackager(DefaultPackager):
    handled_types = (int, float, str, bool)
    artifact_types = ("result", "artifact")
    default_artifact_type = "result"

    def can_pack(self, obj):
        # bool is int's subclass; isinstance covers both deliberately
        return isinstance(obj, self.handled_types)

    def pack(self, context, obj, key, artifact_type="", **cfg):
        if artifact_type == "artifact":
            context.log_artifact(key, body=str(obj))
        else:
            context.log_result(key, obj)

    def unpack(self, data_item, hint):
        raw = data_item.get()
        text = raw.decode() if isinstance(raw, bytes) else raw
        if hint is str:
            return text
        if hint is bool:
            return text.strip().lower() in ("1", "true", "yes")
        return hint(text)


class BytesPackager(DefaultPackager):
    handled_types = (bytes, bytearray)
    priority = 4

    def pack(self, context, obj, key, artifact_type="", **cfg):
        context.log_artifact(key, body=bytes(obj))

    def unpack(self, data_item, hint):
        raw = data_item.get()
        data = raw if isinstance(raw, (bytes, bytearray)) else \
            str(raw).encode()
        return hint(data)


class CollectionPackager(DefaultPackager):
    handled_types = (dict, list, tuple, set, frozenset)
    artifact_types = ("result", "artifact", "file")

    def pack(self, context, obj, key, artifact_type="", **cfg):
        if isinstance(obj, (set, tuple, frozenset)):
            obj = list(obj)
        blob = json.dumps(obj, default=str)
        # small collections → results; big (or explicit) → json artifact
        if artifact_type in ("artifact", "file") or len(blob) > 1024:
            context.log_artifact(key, body=blob, format="json")
        else:
            context.log_result(key, obj)

    def unpack(self, data_item, hint):
        raw = data_item.get()
        text = raw.decode() if isinstance(raw, bytes) else raw
        obj = json.loads(text)
        if hint in (tuple, set, frozenset):
            return hint(obj)
        return obj


class PathPackager(DefaultPackager):
    handled_types = (pathlib.Path, pathlib.PurePath)
    priority = 4

    def can_unpack(self, hint):
        return hint in (pathlib.Path, pathlib.PurePath)

    def pack(self, context, obj, key, artifact_type="", **cfg):
        context.log_artifact(key, local_path=str(obj))

    def unpack(self, data_item, hint):
        return pathlib.Path(data_item.local())


class DataclassPackager(DefaultPackager):
    """Dataclasses round-trip as json artifacts: pack via asdict; unpack
    reconstructs the hinted (or instruction-recorded) dataclass type.
    Nested dataclass fields are re-inflated when the field annotation is
    itself a dataclass."""

    priority = 3  # before CollectionPackager would see asdict-able types

    def can_pack(self, obj):
        import dataclasses

        return dataclasses.is_dataclass(obj) and not isinstance(obj, type)

    def can_unpack(self, hint):
        import dataclasses

        return isinstance(hint, type) and dataclasses.is_dataclass(hint)

    def pack(self, context, obj, key, artifact_type="", **cfg):
        import dataclasses

        context.log_artifact(
            key, body=json.dumps(dataclasses.asdict(obj), default=str),
            format="json")

    def unpack(self, data_item, hint):
        raw = data_item.get()
        data = json.loads(raw.decode() if isinstance(raw, bytes) else raw)
        return self.unpack_dict(data, hint)

    @classmethod
    def unpack_dict(cls, data: dict, hint):
        import dataclasses
        import typing

        try:
            # field.type is a plain STRING under PEP 563 (`from __future__
            # import annotations`) — resolve through get_type_hints so
            # nested dataclasses re-inflate either way
            resolved = typing.get_type_hints(hint)
        except Exception:  # noqa: BLE001 - unresolvable forward refs
            resolved = {}
        kwargs = {}
        for field in dataclasses.fields(hint):
            if field.name not in data:
                continue
            value = data[field.name]
            field_type = resolved.get(field.name, field.type)
            if isinstance(field_type, type) \
                    and dataclasses.is_dataclass(field_type) \
                    and isinstance(value, dict):
                value = cls.unpack_dict(value, field_type)
            kwargs[field.name] = value
        return hint(**kwargs)


class DatetimePackager(DefaultPackager):
    handled_types = (datetime.datetime, datetime.date, datetime.time)
    default_artifact_type = "result"
    priority = 4

    def pack(self, context, obj, key, artifact_type="", **cfg):
        context.log_result(key, obj.isoformat())

    def unpack(self, data_item, hint):
        raw = data_item.get()
        text = (raw.decode() if isinstance(raw, bytes) else raw).strip()
        if hint is datetime.date:
            return datetime.date.fromisoformat(text)
        if hint is datetime.time:
            return datetime.time.fromisoformat(text)
        return datetime.datetime.fromisoformat(text)
