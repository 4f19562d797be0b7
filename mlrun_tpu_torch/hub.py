"""Function hub — the port's copy of ``mlrun_tpu/hub.py``: a hub source
is a directory or url of function yamls, and ``hub://name[:tag]``
resolves against the registered sources in order, then
``MLT_HUB_SOURCE``, then the hub shipped inside the package
(``hub_functions/``, the port's own functions).
"""

from __future__ import annotations

import os

_hub_sources: list[str] = []


def builtin_hub_path() -> str:
    """The hub shipped inside the package (survives pip install)."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "hub_functions")


def add_hub_source(path: str, first: bool = True):
    """Register a hub source: a directory or url prefix holding
    <name>/function.yaml entries."""
    if first:
        _hub_sources.insert(0, path)
    else:
        _hub_sources.append(path)


def list_hub_sources() -> list[str]:
    sources = list(_hub_sources)
    env_source = os.environ.get("MLT_HUB_SOURCE")
    if env_source:
        sources.append(env_source)
    builtin = builtin_hub_path()
    if os.path.isdir(builtin):
        sources.append(builtin)
    return sources


def get_hub_function(url: str) -> dict:
    """Resolve hub://[source/]name[:tag] to a function struct."""
    import yaml

    from .datastore import store_manager

    body = url[len("hub://"):]
    if ":" in body:
        body = body.rsplit(":", 1)[0]
    source_prefix = None
    if "/" in body:
        source_prefix, body = body.split("/", 1)
    name = body.replace("-", "_")

    candidates = list_hub_sources()
    if source_prefix:
        candidates = [s for s in candidates if source_prefix in s] \
            or candidates
    if not candidates:
        raise ValueError(
            f"cannot resolve '{url}': no hub sources registered "
            "(use mlrun_tpu_torch.hub.add_hub_source or MLT_HUB_SOURCE)")
    errors = []
    for source in candidates:
        for candidate_name in (name, name.replace("_", "-")):
            path = os.path.join(source, candidate_name, "function.yaml")
            try:
                item = store_manager.object(url=path)
                return yaml.safe_load(item.get(encoding="utf-8"))
            except Exception as exc:  # noqa: BLE001 - try next source
                errors.append(f"{path}: {exc}")
    raise ValueError(f"hub function '{url}' not found; tried: {errors}")


class FunctionReference:
    """Serializable pointer or spec for a child function."""

    def __init__(self, url: str = "", image: str = "", kind: str = "",
                 code: str = "", spec: dict | None = None, name: str = ""):
        self.url = url
        self.image = image
        self.kind = kind
        self.code = code
        self.spec = spec
        self.name = name
        self._function = None

    def to_dict(self) -> dict:
        return {k: v for k, v in {
            "url": self.url, "image": self.image, "kind": self.kind,
            "code": self.code, "spec": self.spec, "name": self.name,
        }.items() if v}

    @classmethod
    def from_dict(cls, struct: dict) -> "FunctionReference":
        return cls(**{k: struct.get(k) for k in
                      ("url", "image", "kind", "code", "spec", "name")})

    def to_function(self, default_kind: str = ""):
        from .run import import_function, new_function

        if self._function is not None:
            return self._function
        if self.url:
            function = import_function(self.url)
        elif self.spec:
            from .runtimes import get_runtime_class

            kind = self.kind or default_kind or "job"
            function = get_runtime_class(kind).from_dict(self.spec)
            function.kind = kind
        else:
            function = new_function(name=self.name,
                                    kind=self.kind or default_kind)
            if self.code:
                function.with_code(body=self.code)
        if self.image:
            function.spec.image = self.image
        if self.name:
            function.metadata.name = self.name
        self._function = function
        return function
