"""API gateway — the port's copy of ``mlrun_tpu/runtimes/api_gateway.py``
(``APIGateway``: external traffic routed to one or two deployed serving
functions, with optional canary weights and basic auth)."""

from __future__ import annotations

from ..config import run_config
from ..model import ModelObj
from ..utils import normalize_name


class APIGatewaySpec(ModelObj):
    _dict_fields = ["functions", "canary", "host", "path",
                    "authentication_mode", "username", "description"]

    def __init__(self, functions=None, canary=None, host=None, path=None,
                 authentication_mode=None, username=None, description=None):
        self.functions = functions or []      # 1-2 function uris
        self.canary = canary                  # e.g. [90, 10]
        self.host = host
        self.path = path or "/"
        self.authentication_mode = authentication_mode or "none"
        self.username = username
        self.description = description


class APIGateway(ModelObj):
    kind = "api-gateway"
    _dict_fields = ["kind", "metadata", "spec", "status"]

    def __init__(self, name: str = "", project: str = "",
                 functions=None, canary=None, host: str = "",
                 path: str = "/"):
        from .base import FunctionMetadata, FunctionStatus

        self.metadata = FunctionMetadata(
            name=normalize_name(name) if name else None, project=project)
        self.spec = APIGatewaySpec(
            functions=[f if isinstance(f, str) else f.uri
                       for f in (functions or [])],
            canary=canary, host=host, path=path)
        self.status = FunctionStatus()

    def with_basic_auth(self, username: str, password: str):
        self.spec.authentication_mode = "basicAuth"
        self.spec.username = username
        self._password = password
        return self

    def with_canary(self, functions: list, canary: list[int]):
        if len(functions) != 2 or len(canary) != 2 or sum(canary) != 100:
            raise ValueError(
                "canary needs exactly 2 functions and weights summing to 100")
        self.spec.functions = [f if isinstance(f, str) else f.uri
                               for f in functions]
        self.spec.canary = list(canary)
        return self

    def save(self, db=None):
        if db is None:
            from ..db import get_run_db

            db = get_run_db()
        project = self.metadata.project or run_config("default_project")
        db.api_call(
            "POST", f"projects/{project}/api-gateways/{self.metadata.name}",
            json={"data": self.to_dict()})
        return self

    def invoke_url(self) -> str:
        host = self.spec.host or ""
        return f"http://{host}{self.spec.path}" if host else self.spec.path

    def pick_function(self) -> str:
        """A weighted choice between the canary's two functions."""
        import random

        if not self.spec.functions:
            raise ValueError("api gateway has no functions")
        if self.spec.canary and len(self.spec.functions) == 2:
            return random.choices(
                self.spec.functions, weights=self.spec.canary)[0]
        return self.spec.functions[0]
