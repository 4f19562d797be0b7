"""Function deployment manager — the port's copy of
``mlrun_tpu/service/deployments.py``: a deploy request becomes a live
gateway process.

- ``LocalProcessProvider``: allocates a port, starts the port's gateway
  (``python3 -m mlrun_tpu_torch serve``) with the function's env (its
  ``SERVING_SPEC_ENV`` among it), waits for HTTP readiness, and records
  ``http://127.0.0.1:<port>`` in the function's status.
- ``KubernetesProvider``: builds a Deployment (``min_replicas``) and a
  Service; the address is the in-cluster service DNS name.

Gateways are tracked in the ``runtime_resources`` table (kind="gateway")
so they survive service restarts and the monitor loop can flip the
function status to ``error`` when a gateway dies.
"""

from __future__ import annotations

import socket
import threading
import time
import urllib.error
import urllib.request

from ..common.runtimes_constants import PodPhases
from ..config import (
    CLI_COMMAND,
    EXEC_CODE_ENV,
    K8S_DEFAULTS,
    run_config,
    service_config,
)
from ..utils import get_in, logger, update_in

GATEWAY_KIND = "gateway"
# states a gateway-backed function can be in (ready/error/unhealthy)
DEPLOY_READY = "ready"
DEPLOY_ERROR = "error"
DEPLOY_UNHEALTHY = "unhealthy"


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _http_ok(url: str, timeout: float = 1.0) -> bool:
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status < 500
    except (urllib.error.URLError, OSError, ValueError):
        return False


class DeploymentManager:
    """Create/monitor/tear-down live function gateways."""

    def __init__(self, db, provider):
        self.db = db
        self.provider = provider
        # deploys of the SAME function serialize (concurrent deploys would
        # otherwise race teardown/spawn and leak an untracked gateway);
        # different functions still deploy in parallel
        self._locks: dict[tuple, threading.Lock] = {}
        self._locks_guard = threading.Lock()

    def _function_lock(self, name: str, project: str) -> threading.Lock:
        with self._locks_guard:
            return self._locks.setdefault((project, name),
                                          threading.Lock())

    # -- deploy ------------------------------------------------------------
    def deploy(self, function: dict, tag: str = "") -> dict:
        """Start (or replace) the gateway for a function and wait for it to
        come up. Returns ``{"state", "address", "resource_id"}`` and stores
        the function with its refreshed status (deploy returns once the
        function is invocable)."""
        name = get_in(function, "metadata.name", "fn")
        project = get_in(function, "metadata.project",
                         run_config("default_project"))
        tag = tag or get_in(function, "metadata.tag", "") or "latest"

        with self._function_lock(name, project):
            # replace semantics: a re-deploy tears the previous gateway
            # down first so two processes never race for the function's
            # identity
            self.teardown(name, project, store_state=False)

            if self.provider.kind == "kubernetes":
                info = self._deploy_kubernetes(function, name, project,
                                               tag=tag)
            else:
                info = self._deploy_local(function, name, project, tag=tag)

            update_in(function, "status.state", info["state"])
            update_in(function, "status.address", info["address"])
            if info["state"] == DEPLOY_READY:
                update_in(function, "status.external_invocation_urls",
                          [info["address"]])
            self.db.store_function(function, name, project, tag=tag)
            return info

    def _gateway_env(self, function: dict, project: str) -> list[dict]:
        # valueFrom entries (secretKeyRef/fieldRef) pass through for the
        # kubernetes manifest; the local provider only materializes
        # value-typed entries (it has no kubelet to resolve the refs)
        env = [dict(item) for item in
               get_in(function, "spec.env", []) or []
               if isinstance(item, dict)
               and ("value" in item or "valueFrom" in item)]
        names = {item.get("name") for item in env}
        if "MLT_DBPATH" not in names:
            env.append({
                "name": "MLT_DBPATH",
                "value": run_config("dbpath")
                or f"http://127.0.0.1:{service_config('httpdb.port')}"})
        # the gateway is a fresh process: it must not inherit this
        # service's role and try to become a second chief
        env.append({"name": "MLT_CLUSTER_ROLE", "value": ""})
        # embedded user code travels with the gateway (asgi.server_from_env
        # execs it into the graph-class namespace)
        code = get_in(function, "spec.build.functionSourceCode", "")
        if code and EXEC_CODE_ENV not in names:
            env.append({"name": EXEC_CODE_ENV, "value": code})
        # project secrets: plain env with the local provider; with
        # kubernetes they ride a k8s Secret + envFrom (below) so values
        # never appear in the manifest
        if not hasattr(self.provider, "ensure_project_secret"):
            from .secrets import project_secret_env

            for key, value in project_secret_env(self.db, project).items():
                env.append({"name": key, "value": str(value)})
        return env

    def _project_k8s_secrets(self, deployment: dict, project: str):
        ensure = getattr(self.provider, "ensure_project_secret", None)
        if ensure is None:
            return
        from .secrets import project_secret_env

        secrets = project_secret_env(self.db, project)
        if not secrets:
            return
        secret_name = ensure(project, secrets)
        for container in deployment["spec"]["template"]["spec"][
                "containers"]:
            container.setdefault("envFrom", []).append(
                {"secretRef": {"name": secret_name}})

    def _deploy_local(self, function: dict, name: str, project: str,
                      tag: str = "latest") -> dict:
        port = _free_port()
        # bind locally; the *recorded* address uses the advertise host so a
        # status row read from another machine still names a host that
        # resolves to this gateway (``function.gateway_advertise_host``,
        # default 127.0.0.1 for single-host setups)
        advertise = str(service_config("function.gateway_advertise_host")
                        or "127.0.0.1")
        address = f"http://{advertise}:{port}"
        resource = self._build_deployment(
            function, name, project, port=port, replicas=1,
            host="127.0.0.1" if advertise == "127.0.0.1" else "0.0.0.0")
        uid = f"gateway-{name}"
        try:
            resource_id = self.provider.create(resource, uid)
        except Exception as exc:  # noqa: BLE001
            logger.warning("gateway spawn failed", function=name,
                           error=str(exc))
            return {"state": DEPLOY_ERROR, "address": "",
                    "resource_id": "", "error": str(exc)}
        self.db.store_runtime_resource(uid, project, GATEWAY_KIND,
                                       resource_id, time.time(), tag=tag)
        ready_timeout = float(service_config("function.gateway_ready_timeout"))
        if get_in(function, "spec.build.requirements", None):
            # first boot pip-installs the overlay before the server binds
            ready_timeout = max(ready_timeout * 3, 60.0)
        deadline = time.time() + ready_timeout
        # readiness always polls loopback — the gateway is a child of this
        # service even when the advertised address names another interface
        probe = f"http://127.0.0.1:{port}"
        while time.time() < deadline:
            if _http_ok(f"{probe}/__stats__"):
                logger.info("gateway ready", function=name,
                            address=address)
                return {"state": DEPLOY_READY, "address": address,
                        "resource_id": resource_id}
            if self.provider.state(resource_id) not in (
                    PodPhases.running, PodPhases.pending):
                break
            time.sleep(0.2)
        # the local provider pumps gateway stdout into the log store under
        # the gateway uid — surface the tail so the failure is diagnosable
        log = b""
        try:
            _, log = self.db.get_log(uid, project)
        except Exception:  # noqa: BLE001
            pass
        self.provider.delete(resource_id)
        self.db.del_runtime_resource(uid, project)
        tail = log[-2000:].decode(errors="replace") if log else ""
        logger.warning("gateway did not become ready", function=name,
                       tail=tail)
        return {"state": DEPLOY_ERROR, "address": "", "resource_id": "",
                "error": f"gateway did not become ready: {tail}"}

    def _deploy_kubernetes(self, function: dict, name: str,
                           project: str, tag: str = "latest") -> dict:
        port = int(get_in(function, "spec.config.http.port", 0) or 8080)
        deployment = self._build_deployment(
            function, name, project, port=port,
            replicas=int(get_in(function, "spec.min_replicas", 1) or 1))
        service = self._build_service(name, project, port)
        self._project_k8s_secrets(deployment, project)
        uid = f"gateway-{name}"
        try:
            resource_id = self.provider.create(deployment, uid)
            self.provider.create_service(service)
        except Exception as exc:  # noqa: BLE001 - deploy() error contract:
            # quota/409/validation failures must come back as a state=error
            # dict (like _deploy_local), not a raw 500
            logger.warning("gateway deployment create failed",
                           function=name, error=str(exc))
            return {"state": DEPLOY_ERROR, "address": "",
                    "resource_id": "", "error": str(exc)}
        self.db.store_runtime_resource(uid, project, GATEWAY_KIND,
                                       resource_id, time.time(), tag=tag)
        address = (f"http://{service['metadata']['name']}."
                   f"{K8S_DEFAULTS['namespace']}.svc.cluster.local:{port}")
        ready_timeout = float(service_config("function.gateway_ready_timeout"))
        if get_in(function, "spec.build.requirements", None):
            # first boot pip-installs the overlay before the server binds
            # — the same allowance the local path grants (without it a
            # requirement-bearing gateway comes up DEPLOY_UNHEALTHY)
            ready_timeout = max(ready_timeout * 3, 60.0)
        deadline = time.time() + ready_timeout
        while time.time() < deadline:
            if self.provider.state(resource_id) == PodPhases.running:
                return {"state": DEPLOY_READY, "address": address,
                        "resource_id": resource_id}
            time.sleep(1.0)
        # k8s keeps retrying the rollout in the background; report the
        # address but not ready
        return {"state": DEPLOY_UNHEALTHY, "address": address,
                "resource_id": resource_id}

    def _build_deployment(self, function: dict, name: str, project: str,
                          port: int, replicas: int,
                          host: str = "0.0.0.0") -> dict:
        labels = {
            "mlrun-tpu/project": project,
            "mlrun-tpu/uid": f"gateway-{name}",
            "mlrun-tpu/class": GATEWAY_KIND,
            "mlrun-tpu/function": name,
        }
        # gateways honor build.requirements like batch runs do: the serve
        # command bootstraps onto the cached requirements overlay first
        # (runtime_handlers._wrap_with_bootstrap is the batch-side analog;
        # without this a serving function declaring requirements would
        # silently come up without them)
        command = CLI_COMMAND + ["serve", "--port", str(port),
                                 "--host", host]
        requirements = list(
            get_in(function, "spec.build.requirements", []) or [])
        if requirements:
            wrapped = CLI_COMMAND + ["bootstrap"]
            for req in requirements:
                wrapped += ["-r", req]
            command = wrapped + ["--"] + command
        container = {
            "name": "gateway",
            "image": get_in(function, "spec.image", "")
            or run_config("default_image"),
            "command": command,
            "env": self._gateway_env(function, project),
            "ports": [{"containerPort": port}],
            "readinessProbe": {
                "httpGet": {"path": "/__stats__", "port": port},
                "periodSeconds": 5,
            },
        }
        resources = get_in(function, "spec.resources", None)
        if resources:
            container["resources"] = resources
        return {
            "apiVersion": "apps/v1",
            "kind": "Deployment",
            "metadata": {
                "name": f"mlt-gw-{project}-{name}"[:63],
                "namespace": K8S_DEFAULTS["namespace"],
                "labels": labels,
            },
            "spec": {
                "replicas": replicas,
                "selector": {"matchLabels": {
                    "mlrun-tpu/function": name,
                    "mlrun-tpu/project": project}},
                "template": {
                    "metadata": {"labels": labels},
                    "spec": {"containers": [container],
                             "restartPolicy": "Always"},
                },
            },
        }

    @staticmethod
    def _build_service(name: str, project: str, port: int) -> dict:
        return {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {
                "name": f"mlt-gw-{project}-{name}"[:63],
                "namespace": K8S_DEFAULTS["namespace"],
                "labels": {"mlrun-tpu/class": GATEWAY_KIND,
                           "mlrun-tpu/project": project,
                           "mlrun-tpu/function": name},
            },
            "spec": {
                "selector": {"mlrun-tpu/function": name,
                             "mlrun-tpu/project": project},
                "ports": [{"port": port, "targetPort": port}],
            },
        }

    # -- lifecycle ---------------------------------------------------------
    def teardown(self, name: str, project: str,
                 store_state: bool = True) -> bool:
        """Stop the gateway (if any). With ``store_state`` the function's
        status flips to offline so clients stop invoking it."""
        uid = f"gateway-{name}"
        row = self._resource_row(uid, project)
        if row is None:
            return False
        try:
            self.provider.delete(row["resource_id"])
        except Exception as exc:  # noqa: BLE001
            logger.warning("gateway delete failed", function=name,
                           error=str(exc))
        self.db.del_runtime_resource(uid, project)
        if store_state:
            self._set_function_state(name, project, "offline",
                                     tag=row.get("tag", ""))
        return True

    def monitor(self):
        """Flip functions whose gateway died to ``error``, and promote an
        unhealthy one whose resource now runs back to ``ready``. Called
        from the service monitor loop."""
        for row in self.db.list_runtime_resources(kind=GATEWAY_KIND):
            uid = row["uid"]
            if not uid.startswith("gateway-"):
                continue
            name = uid.split("-", 1)[1]
            try:
                live = self.provider.state(row["resource_id"])
            except Exception as exc:  # noqa: BLE001
                # a 404 means the resource was deleted out-of-band
                # (kubectl delete) — that's a dead gateway, not a blip;
                # anything else (API hiccup) is skipped until next tick
                if getattr(exc, "status", None) == 404 \
                        or "not found" in str(exc).lower():
                    live = PodPhases.failed
                else:
                    continue
            if live == PodPhases.running:
                # the rollout settled after deploy() stopped waiting —
                # promote the function back to ready (else a slow first
                # boot stays 'unhealthy' after the pod is up). Cheap lock-free peek first: the all-healthy steady state
                # must not take N function locks per tick
                if not self._is_unhealthy(name, row["project"],
                                          tag=row.get("tag", "")):
                    continue
                with self._function_lock(name, row["project"]):
                    current = self._resource_row(uid, row["project"])
                    if current is not None and \
                            current["resource_id"] == row["resource_id"]:
                        self._promote_if_unhealthy(
                            name, row["project"], tag=row.get("tag", ""))
                continue
            if live in (PodPhases.failed, PodPhases.succeeded):
                # serialize with deploy(): a concurrent redeploy may have
                # just replaced this row — re-read under the lock and only
                # act if the dead resource is still the tracked one
                with self._function_lock(name, row["project"]):
                    current = self._resource_row(uid, row["project"])
                    if current is None or \
                            current["resource_id"] != row["resource_id"]:
                        continue
                    logger.warning("gateway died", function=name,
                                   project=row["project"], state=live)
                    # delete the provider resource too: a crash-looping
                    # k8s Deployment would otherwise stay in the cluster
                    # untracked and block every future redeploy with
                    # AlreadyExists
                    try:
                        self.provider.delete(row["resource_id"])
                    except Exception:  # noqa: BLE001 - already gone
                        pass
                    self.db.del_runtime_resource(uid, row["project"])
                    self._set_function_state(name, row["project"],
                                             DEPLOY_ERROR,
                                             tag=row.get("tag", ""))

    def _resource_row(self, uid: str, project: str) -> dict | None:
        for row in self.db.list_runtime_resources(kind=GATEWAY_KIND):
            if row["uid"] == uid and row["project"] == project:
                return row
        return None

    def _is_unhealthy(self, name: str, project: str,
                      tag: str = "") -> bool:
        try:
            function = self.db.get_function(name, project,
                                            tag=tag or "latest")
        except Exception:  # noqa: BLE001
            return False
        return bool(function) and get_in(
            function, "status.state", "") == DEPLOY_UNHEALTHY

    def _promote_if_unhealthy(self, name: str, project: str,
                              tag: str = ""):
        tag = tag or "latest"
        try:
            function = self.db.get_function(name, project, tag=tag)
        except Exception:  # noqa: BLE001
            return
        if not function or get_in(
                function, "status.state", "") != DEPLOY_UNHEALTHY:
            return
        address = get_in(function, "status.address", "")
        update_in(function, "status.state", DEPLOY_READY)
        if address:
            update_in(function, "status.external_invocation_urls",
                      [address])
        self.db.store_function(function, name, project, tag=tag)
        logger.info("gateway recovered", function=name, project=project)

    def _set_function_state(self, name: str, project: str, state: str,
                            tag: str = ""):
        # the deployed tag rides the runtime-resource row — a gateway
        # deployed as mytag must flip mytag's stored function, not latest
        tag = tag or "latest"
        try:
            function = self.db.get_function(name, project, tag=tag)
        except Exception:  # noqa: BLE001
            return
        if not function:
            return
        update_in(function, "status.state", state)
        if state != DEPLOY_READY:
            update_in(function, "status.address", "")
            update_in(function, "status.external_invocation_urls", [])
        self.db.store_function(function, name, project, tag=tag)
