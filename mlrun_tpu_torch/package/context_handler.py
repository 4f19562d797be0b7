"""Handler I/O mediation — the port's counterpart of
``mlrun_tpu/package/context_handler.py``.

Parses the user handler's signature + type hints, converts incoming
``DataItem`` inputs to the hinted types, injects the context, and packages
returned values into results / artifacts via the packagers manager. The
context is an ``MLClientCtx`` (``runtimes/local.exec_from_params``) or any
duck-typed one (an object with ``log_result`` and ``log_artifact``); the
parameters and inputs are plain dicts, an input a ``DataItem`` or a url
the context's ``get_input`` resolves (its input path, ``store://`` uris in
its project), else the port's datastore.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, get_type_hints

from ..datastore import store_manager
from ..datastore.base import DataItem
from .packagers_manager import PackagersManager


def _is_context(value) -> bool:
    return hasattr(value, "log_result") and hasattr(value, "log_artifact")


class ContextHandler:
    def __init__(self):
        self._manager = PackagersManager()

    def look_for_context(self, args: tuple, kwargs: dict):
        for value in list(args) + list(kwargs.values()):
            if _is_context(value):
                return value
        return None

    def parse_inputs(self, handler: Callable, context,
                     parameters: dict | None = None,
                     inputs: dict | None = None) -> dict:
        """Build handler kwargs from parameters + inputs, honoring type
        hints."""
        sig = inspect.signature(handler)
        try:
            hints = get_type_hints(handler)
        except Exception:  # noqa: BLE001 - unresolvable hints are non-fatal
            hints = {}
        params = parameters or {}
        inputs = inputs or {}
        kwargs: dict[str, Any] = {}
        for name, param in sig.parameters.items():
            if param.kind in (param.VAR_POSITIONAL, param.VAR_KEYWORD):
                continue
            hint = hints.get(name)
            if name in ("context", "ctx"):
                kwargs[name] = context
            elif name in inputs:
                item = inputs[name]
                if not isinstance(item, DataItem):
                    get_input = getattr(context, "get_input", None)
                    item = get_input(name, str(item)) if callable(get_input) \
                        else store_manager.object(url=str(item), key=name)
                kwargs[name] = self._manager.unpack(item, hint)
            elif name in params:
                kwargs[name] = params[name]
            elif param.default is not param.empty:
                kwargs[name] = param.default
        # pass through extra params the signature accepts via **kwargs
        if any(p.kind == p.VAR_KEYWORD for p in sig.parameters.values()):
            for key, value in params.items():
                kwargs.setdefault(key, value)
        return kwargs

    def package_results(self, context, results: Any,
                        returns: list | None):
        """Log returned values through the packagers manager."""
        if results is None:
            return
        returns = returns or []
        if not isinstance(results, tuple):
            results = (results,)
        for index, value in enumerate(results):
            log_hint = self._log_hint(returns, index)
            self._manager.pack(context, value, log_hint)

    @staticmethod
    def _log_hint(returns: list, index: int) -> dict:
        if index < len(returns):
            hint = returns[index]
            if isinstance(hint, str):
                # "key" or "key:artifact_type"
                if ":" in hint:
                    key, artifact_type = hint.split(":", 1)
                    return {"key": key, "artifact_type": artifact_type}
                return {"key": hint}
            return dict(hint)
        return {"key": f"return_{index}" if index else "return"}
