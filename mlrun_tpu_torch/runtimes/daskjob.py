"""Dask runtime — the port's copy of ``mlrun_tpu/runtimes/daskjob.py``.

A client-side dask cluster for dataframe-parallel work and as a
hyper-param parallel engine: a CPU engine beside the GPU pods (tensor
work belongs to tpujob). The k8s deployment path materializes a scheduler
Deployment+Service and a worker Deployment (built here, created through
the kubernetes package) and the client connects to the scheduler service
— no dask-operator dependency. ``dask`` and ``kubernetes`` are imported
inside the calls that need them.
"""

from __future__ import annotations

import os

from ..config import K8S_DEFAULTS, service_config
from ..common.runtimes_constants import RuntimeKinds
from ..model import RunObject
from ..utils import logger
from .pod import KubeResource, KubeResourceSpec


class DaskSpec(KubeResourceSpec):
    _dict_fields = KubeResourceSpec._dict_fields + [
        "min_replicas", "max_replicas", "scheduler_timeout",
        "scheduler_address", "worker_resources",
    ]

    def __init__(self, min_replicas=None, max_replicas=None,
                 scheduler_timeout=None, scheduler_address=None,
                 worker_resources=None, **kwargs):
        super().__init__(**kwargs)
        self.min_replicas = min_replicas or 0
        self.max_replicas = max_replicas or 4
        self.scheduler_timeout = scheduler_timeout or "60 minutes"
        # set (or discovered from the k8s service) → client connects remote
        self.scheduler_address = scheduler_address or ""
        self.worker_resources = worker_resources or {}


class DaskRuntime(KubeResource):
    kind = RuntimeKinds.dask
    _is_remote = False  # the cluster is remote, but run() drives it client-side
    _nested_fields = {**KubeResource._nested_fields, "spec": DaskSpec}

    def __init__(self, metadata=None, spec=None, status=None):
        super().__init__(metadata, spec, status)
        if not isinstance(self.spec, DaskSpec):
            self.spec = DaskSpec.from_dict(self.spec.to_dict())
        self._cluster = None
        self._client = None
        self._client_address = ""

    @property
    def client(self):
        """Return a dask client: remote when a scheduler address is set
        (e.g. after deploy_cluster), else a local cluster."""
        try:
            from dask.distributed import Client, LocalCluster
        except ImportError as exc:
            raise ImportError(
                "dask is not installed in this environment") from exc
        # cache per scheduler address: changing spec.scheduler_address (or
        # clearing it) invalidates the cached client instead of returning a
        # stale connection
        address = self.spec.scheduler_address or ""
        if self._client is not None and self._client_address == address:
            return self._client
        if self._client is not None:
            try:
                self._client.close()
            except Exception:  # noqa: BLE001
                pass
            self._client = None
        if address:
            self._client = Client(address)
        else:
            if self._cluster is None:
                self._cluster = LocalCluster(
                    n_workers=max(1, self.spec.min_replicas or 1),
                    threads_per_worker=2)
            self._client = Client(self._cluster)
        self._client_address = address
        return self._client

    def close(self):
        if self._client is not None:
            try:
                self._client.close()
            except Exception:  # noqa: BLE001 - already-dead scheduler
                pass
            self._client = None
        if self._cluster is not None:
            self._cluster.close()
            self._cluster = None

    # -- k8s deployment (reference: the dask-kubernetes cluster flow) -------
    def _cluster_name(self) -> str:
        return f"mlt-dask-{self.metadata.name or 'cluster'}"

    def generate_cluster_resources(self, namespace: str | None = None) -> dict:
        """Build the scheduler Deployment+Service and worker Deployment
        manifests (pure builders — unit-testable without a cluster)."""
        namespace = namespace or K8S_DEFAULTS["namespace"]
        name = self._cluster_name()
        image = self.spec.image or service_config("function.dask_image")
        labels = {"mlrun-tpu/class": "dask", "mlrun-tpu/cluster": name}

        def deployment(component: str, command: list, replicas: int,
                       resources: dict | None = None):
            pod_labels = dict(labels, **{"mlrun-tpu/component": component})
            container = {
                "name": component,
                "image": image,
                "args": command,
                "env": [{"name": k, "value": str(v)}
                        for k, v in (self.spec.env or {}).items()]
                if isinstance(self.spec.env, dict) else (self.spec.env or []),
            }
            if resources:
                container["resources"] = {"limits": resources}
            return {
                "apiVersion": "apps/v1",
                "kind": "Deployment",
                "metadata": {"name": f"{name}-{component}",
                             "namespace": namespace,
                             "labels": labels},
                "spec": {
                    "replicas": replicas,
                    "selector": {"matchLabels": pod_labels},
                    "template": {"metadata": {"labels": pod_labels},
                                 "spec": {"containers": [container]}},
                },
            }

        scheduler = deployment(
            "scheduler", ["dask", "scheduler", "--port", "8786",
                          "--dashboard-address", ":8787"], 1)
        workers = deployment(
            "worker",
            ["dask", "worker", f"tcp://{name}-scheduler:8786"],
            max(1, self.spec.min_replicas or 1),
            resources=self.spec.worker_resources or None)
        service = {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {"name": f"{name}-scheduler",
                         "namespace": namespace, "labels": labels},
            "spec": {
                "selector": dict(labels,
                                 **{"mlrun-tpu/component": "scheduler"}),
                "ports": [
                    {"name": "scheduler", "port": 8786,
                     "targetPort": 8786},
                    {"name": "dashboard", "port": 8787,
                     "targetPort": 8787},
                ],
            },
        }
        return {"scheduler": scheduler, "workers": workers,
                "service": service}

    def deploy_cluster(self, namespace: str | None = None) -> str:
        """Create the cluster on kubernetes (gated on the kubernetes
        package) and record the scheduler address; returns it."""
        import kubernetes  # gated import

        if os.environ.get("KUBERNETES_SERVICE_HOST"):
            kubernetes.config.load_incluster_config()
        else:
            kubernetes.config.load_kube_config()
        namespace = namespace or K8S_DEFAULTS["namespace"]
        resources = self.generate_cluster_resources(namespace)
        apps = kubernetes.client.AppsV1Api()
        core = kubernetes.client.CoreV1Api()
        apps.create_namespaced_deployment(namespace, resources["scheduler"])
        apps.create_namespaced_deployment(namespace, resources["workers"])
        core.create_namespaced_service(namespace, resources["service"])
        self.spec.scheduler_address = (
            f"tcp://{self._cluster_name()}-scheduler.{namespace}:8786")
        logger.info("dask cluster deployed",
                    scheduler=self.spec.scheduler_address)
        return self.spec.scheduler_address

    def delete_cluster(self, namespace: str | None = None):
        import kubernetes  # gated import

        namespace = namespace or K8S_DEFAULTS["namespace"]
        name = self._cluster_name()
        apps = kubernetes.client.AppsV1Api()
        core = kubernetes.client.CoreV1Api()
        for component in ("scheduler", "worker"):
            try:
                apps.delete_namespaced_deployment(f"{name}-{component}",
                                                  namespace)
            except kubernetes.client.exceptions.ApiException:
                pass
        try:
            core.delete_namespaced_service(f"{name}-scheduler", namespace)
        except kubernetes.client.exceptions.ApiException:
            pass
        self.spec.scheduler_address = ""

    def _run(self, runobj: RunObject, execution) -> dict:
        from .local import exec_from_params, load_module

        handler = runobj.spec.handler
        if not callable(handler):
            command = self.spec.command
            if not command:
                raise ValueError("dask runtime needs a handler or command")
            handler = load_module(command, runobj.spec.handler_name or "handler")
        return exec_from_params(handler, runobj, execution)
