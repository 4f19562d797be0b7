"""Type → artifact codec system — the port's copy of
``mlrun_tpu/package/packagers_manager.py``.

``pack`` routes a returned python object to log_result / log_dataset /
log_artifact / log_model by type family; ``unpack`` converts a DataItem to
the type hinted on the handler parameter. Families live in
``package/packagers/`` (stdlib, numpy, pandas, torch) ordered by priority;
type hints may be concrete types, strings ("pandas.DataFrame"), or typing
constructs (Optional/Union/List[...] — see type_hints.reduce_hint). Torch
tensors, param trees and numpy arrays are first-class. The context is
duck-typed (``log_result``, ``log_artifact``, ``log_dataset``,
``log_model``).
"""

from __future__ import annotations

from typing import Any

from ..utils import logger
from .packagers import DEFAULT_PACKAGERS
from .packagers.default import DefaultPackager
from .type_hints import reduce_hint

# re-exported names (user code may subclass these)
from .packagers import (  # noqa: F401  (re-exports)
    CollectionPackager,
    NumpyArrayPackager as NumpyPackager,
    PandasDataFramePackager as PandasPackager,
    PathPackager,
    PrimitivePackager,
    TorchTensorPackager as TorchPackager,
)

Packager = DefaultPackager  # the reference's name for the base class


class PackagersManager:
    def __init__(self):
        self._packagers: list[DefaultPackager] = sorted(
            (cls() for cls in DEFAULT_PACKAGERS),
            key=lambda p: p.priority)

    def register(self, packager: DefaultPackager, first: bool = True):
        if first:
            self._packagers.insert(0, packager)
        else:
            self._packagers.append(packager)

    def pack(self, context, obj: Any, log_hint: dict):
        key = log_hint.get("key", "return")
        artifact_type = log_hint.get("artifact_type") or ""
        if artifact_type == "result":
            # explicit result hint wins regardless of family
            if _jsonable(obj):
                context.log_result(key, obj)
                return
        if artifact_type == "model":
            context.log_model(
                key, body=obj if isinstance(obj, (bytes, str)) else None)
            return
        cfg = {k: v for k, v in log_hint.items()
               if k not in ("key", "artifact_type")}
        for packager in self._packagers:
            try:
                if packager.can_pack(obj):
                    # unpackaging instructions ride the artifact's FIRST
                    # store (reference packagers_manager records the same,
                    # so a hint-free downstream handler gets the original
                    # type back); the stamping proxy injects them into the
                    # packager's log_artifact call — no re-store
                    obj_type = type(obj)
                    stamping = _StampingContext(context, {
                        "packager": type(packager).__name__,
                        "object_type": f"{obj_type.__module__}."
                                       f"{obj_type.__qualname__}",
                        "artifact_type": artifact_type or "",
                    })
                    try:
                        packager.pack(stamping, obj, key,
                                      artifact_type=artifact_type, **cfg)
                    finally:
                        packager.cleanup()
                    return
            except ImportError:
                continue
        # fallback: stringify into a result
        context.log_result(key, str(obj))

    def unpack(self, data_item, hint):
        from ..datastore.base import DataItem

        candidates = reduce_hint(hint)
        if not candidates:
            # no hint: honor recorded unpackaging instructions, so the
            # handler receives the ORIGINAL packed type end-to-end
            unpacked = self._unpack_by_instructions(data_item)
            if unpacked is not _NO_INSTRUCTIONS:
                return unpacked
            return data_item
        if DataItem in candidates:
            return data_item
        if str in candidates and data_item.kind == "file":
            # mirror the reference convention: str hint on an input = local
            # path
            return data_item.local()
        for candidate in candidates:
            for packager in self._packagers:
                try:
                    if packager.can_unpack(candidate):
                        return packager.unpack(data_item, candidate)
                except ImportError:
                    continue
        return data_item

    def _unpack_by_instructions(self, data_item):
        """Reconstruct the packed object from the artifact spec's recorded
        unpackaging_instructions (written by ``_record_instructions``)."""
        meta = getattr(data_item, "meta", None) or {}
        instructions = (meta.get("spec") or {}).get(
            "unpackaging_instructions") or {}
        obj_path = instructions.get("object_type", "")
        if not obj_path:
            return _NO_INSTRUCTIONS
        obj_type = _resolve_type(obj_path, trusted=False)
        if obj_type is None:
            logger.warning("unpackaging instructions name an unresolvable "
                           "type — handing back the DataItem",
                           object_type=obj_path)
            return _NO_INSTRUCTIONS
        # prefer the recorded packager; fall back to can_unpack dispatch
        name = instructions.get("packager", "")
        ordered = sorted(self._packagers,
                         key=lambda p: type(p).__name__ != name)
        for packager in ordered:
            try:
                if packager.can_unpack(obj_type):
                    return packager.unpack(data_item, obj_type)
            except ImportError:
                continue
        return _NO_INSTRUCTIONS


def _jsonable(obj) -> bool:
    import json

    try:
        json.dumps(obj)
        return True
    except (TypeError, ValueError):
        return False


class _StampingContext:
    """Context proxy: adds the unpackaging instructions to artifacts the
    wrapped packager logs (everything else passes straight through)."""

    def __init__(self, context, instructions: dict):
        self._context = context
        self._instructions = instructions

    def log_artifact(self, *args, **kwargs):
        kwargs.setdefault("unpackaging_instructions", self._instructions)
        return self._context.log_artifact(*args, **kwargs)

    def log_dataset(self, *args, **kwargs):
        # pandas packagers log through log_dataset — it forwards **kwargs
        # to the artifact manager, so dataset artifacts get stamped too
        kwargs.setdefault("unpackaging_instructions", self._instructions)
        return self._context.log_dataset(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._context, name)


_NO_INSTRUCTIONS = object()  # sentinel: no usable recorded instructions


def _allowed_instruction_module(path: str) -> bool:
    """Unpackaging instructions are *artifact metadata* — attacker-shaped
    input, unlike handler type hints the user wrote. Restrict the module
    an instruction may name to builtins, ``mlrun_tpu_torch`` itself, and
    modules this process ALREADY imported, so a crafted artifact spec
    cannot trigger an arbitrary import (and its module-level code)."""
    import sys

    if "." not in path:
        return True  # bare builtin name; parse_string_hint checks builtins
    from .type_hints import _SHORTHAND_MODULES

    root = path.split(".", 1)[0]
    root = _SHORTHAND_MODULES.get(root, root).split(".", 1)[0]
    return root == "mlrun_tpu_torch" or root in sys.modules


def _resolve_type(path: str, trusted: bool = True):
    """'module.Qualified.Name' -> type via the shared string-hint
    resolver (type_hints.parse_string_hint handles shorthand modules and
    nested classes for both paths). ``trusted=False`` applies the
    instruction-metadata allowlist first."""
    from .type_hints import parse_string_hint

    if not trusted and not _allowed_instruction_module(path):
        logger.warning("unpackaging instructions name a module outside "
                       "the allowlist — refusing to import it",
                       object_type=path)
        return None
    resolved = parse_string_hint(path)
    return resolved if isinstance(resolved, type) else None
