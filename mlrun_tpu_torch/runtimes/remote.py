"""HTTP-triggered function runtimes — the port's copy of
``mlrun_tpu/runtimes/remote.py`` (``RemoteRuntime``, ``ApplicationRuntime``).
A deploy is the service's: its deployment manager starts the function's
gateway (``python3 -m mlrun_tpu_torch serve``) and records the address;
``invoke`` calls that address over HTTP.
"""

from __future__ import annotations

from ..common.runtimes_constants import RuntimeKinds
from ..model import RunObject
from ..utils import logger
from .pod import KubeResource, KubeResourceSpec


class RemoteSpec(KubeResourceSpec):
    _dict_fields = KubeResourceSpec._dict_fields + [
        "min_replicas", "max_replicas", "function_handler", "base_spec",
        "config",
    ]

    def __init__(self, min_replicas=None, max_replicas=None,
                 function_handler=None, base_spec=None, config=None, **kwargs):
        super().__init__(**kwargs)
        self.min_replicas = min_replicas or 1
        self.max_replicas = max_replicas or 4
        self.function_handler = function_handler
        self.base_spec = base_spec or {}
        self.config = config or {}


class RemoteRuntime(KubeResource):
    kind = RuntimeKinds.remote
    _is_remote = True
    _nested_fields = {**KubeResource._nested_fields, "spec": RemoteSpec}

    def __init__(self, metadata=None, spec=None, status=None):
        super().__init__(metadata, spec, status)
        if not isinstance(self.spec, RemoteSpec):
            self.spec = RemoteSpec.from_dict(self.spec.to_dict())

    def with_http(self, workers: int = 8, port: int = 0, host: str = ""):
        self.spec.config["http"] = {"workers": workers, "port": port,
                                    "host": host}
        return self

    def add_trigger(self, name: str, spec: dict):
        self.spec.config.setdefault("triggers", {})[name] = spec
        return self

    def deploy(self, project: str = "", tag: str = "", verbose: bool = False):
        """Deploy through the service and return once the gateway answers
        (its address); a failed deploy raises with the gateway's log
        tail."""
        db = self._get_db()
        resp = db.api_call(
            "POST", f"projects/{self.metadata.project or 'default'}/"
            f"functions/{self.metadata.name}/deploy",
            json={"function": self.to_dict()})
        data = resp.get("data", resp) if isinstance(resp, dict) else {}
        address = data.get("address", "")
        self.status.address = address
        self.status.state = data.get("state", "ready")
        if address:
            self.status.external_invocation_urls = [address]
        if self.status.state == "error":
            raise RuntimeError(
                f"function deploy failed: {data.get('error', 'unknown')}")
        logger.info("function deployed", address=address,
                    state=self.status.state)
        return address

    def undeploy(self, project: str = ""):
        """Tear the live gateway down (the function's state reads
        offline)."""
        db = self._get_db()
        db.api_call(
            "DELETE", f"projects/{self.metadata.project or 'default'}/"
            f"functions/{self.metadata.name}/deploy")
        self.status.address = ""
        self.status.state = "offline"
        self.status.external_invocation_urls = []

    def invoke(self, path: str = "/", body=None, method: str = "",
               headers: dict | None = None, dashboard: str = "",
               force_external_address: bool = False):
        """Call the deployed endpoint: the JSON answer, else its bytes."""
        import requests

        address = self.status.address
        if not address:
            raise ValueError("function is not deployed (no address)")
        if not address.startswith("http"):
            address = f"http://{address}"
        method = method or ("POST" if body is not None else "GET")
        kwargs = {}
        if isinstance(body, (dict, list)):
            kwargs["json"] = body
        elif body is not None:
            kwargs["data"] = body
        resp = requests.request(
            method, f"{address.rstrip('/')}/{path.lstrip('/')}",
            headers=headers, timeout=30, **kwargs)
        resp.raise_for_status()
        try:
            return resp.json()
        except ValueError:
            return resp.content

    def _run(self, runobj: RunObject, execution) -> dict:
        raise RuntimeError(
            "remote functions are invoked over http — use deploy() + invoke()")


class ApplicationRuntime(RemoteRuntime):
    """A generic always-on application."""

    kind = RuntimeKinds.application

    def with_sidecar(self, name: str, image: str, ports: list | None = None,
                     command: list | None = None):
        self.spec.config.setdefault("sidecars", []).append({
            "name": name, "image": image, "ports": ports or [],
            "command": command or []})
        return self
