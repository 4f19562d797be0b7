"""Kubernetes pod-based resource spec — the port's copy of
``mlrun_tpu/runtimes/pod.py`` (``KubeResource``, ``KubeResourceSpec``),
sized in GPUs: ``with_limits(gpus=)`` requests ``nvidia.com/gpu`` and
``with_gpus`` adds the GPU product's node selector, where the reference
requests ``google.com/tpu`` chips with TPU accelerator and topology
selectors (``with_tpu``)."""

from __future__ import annotations

from ..config import K8S_DEFAULTS
from ..k8s.jobset import GPU_PRODUCT_SELECTOR, GPU_RESOURCE, TopologyError
from ..model import ModelObj
from .base import BaseRuntime, FunctionSpec


class KubeResourceSpec(FunctionSpec):
    _dict_fields = FunctionSpec._dict_fields + [
        "volumes", "volume_mounts", "affinity", "tolerations",
        "security_context",
    ]

    def __init__(self, volumes=None, volume_mounts=None, affinity=None,
                 tolerations=None, security_context=None, **kwargs):
        super().__init__(**kwargs)
        self.volumes = volumes or []
        self.volume_mounts = volume_mounts or []
        self.affinity = affinity
        self.tolerations = tolerations or []
        self.security_context = security_context


class KubeResource(BaseRuntime):
    """Base for all pod-creating runtimes."""

    kind = "pod"
    _is_remote = True
    _nested_fields = {**BaseRuntime._nested_fields, "spec": KubeResourceSpec}

    def __init__(self, metadata=None, spec=None, status=None):
        super().__init__(metadata, spec, status)
        if not isinstance(self.spec, KubeResourceSpec):
            self.spec = KubeResourceSpec.from_dict(
                self.spec.to_dict() if isinstance(self.spec, ModelObj)
                else (self.spec or {}))

    # -- resources ---------------------------------------------------------
    def with_requests(self, mem: str | None = None, cpu: str | None = None):
        requests = self.spec.resources.setdefault("requests", {})
        if mem:
            requests["memory"] = mem
        if cpu:
            requests["cpu"] = cpu
        return self

    def with_limits(self, mem: str | None = None, cpu: str | None = None,
                    gpus: int | None = None,
                    gpu_type: str | None = None):
        """Set container limits. ``gpus`` requests GPUs of the
        ``gpu_type`` resource (``nvidia.com/gpu``)."""
        limits = self.spec.resources.setdefault("limits", {})
        if mem:
            limits["memory"] = mem
        if cpu:
            limits["cpu"] = cpu
        if gpus is not None:
            limits[gpu_type or GPU_RESOURCE] = gpus
        return self

    def with_gpus(self, gpus: int = 1, gpu_product: str | None = None):
        """Request ``gpus`` GPUs a pod and a node of ``gpu_product``
        (default ``K8S_DEFAULTS["gpu_product"]``)."""
        self.with_limits(gpus=gpus)
        self.spec.node_selector[GPU_PRODUCT_SELECTOR] = (
            gpu_product or K8S_DEFAULTS["gpu_product"])
        return self

    def with_tpu(self, *args, **kwargs):
        """TPU chips: a GPU pod is sized with :meth:`with_gpus`."""
        raise TopologyError(
            "the port sizes pods in GPUs: use with_gpus(gpus, gpu_product) "
            "instead of with_tpu(chips, accelerator, topology)")

    def with_node_selection(self, node_selector: dict | None = None,
                            affinity=None, tolerations=None):
        if node_selector:
            self.spec.node_selector.update(node_selector)
        if affinity is not None:
            self.spec.affinity = affinity
        if tolerations is not None:
            self.spec.tolerations = tolerations
        return self

    def with_priority_class(self, name: str):
        self.spec.priority_class_name = name
        return self

    def with_preemption_mode(self, mode: str):
        # allow | constrain | prevent — spot or reserved nodes
        self.spec.preemption_mode = mode
        return self

    def apply(self, modifier):
        """Apply a pod modifier (mount decorators, reference platforms/)."""
        modifier(self)
        return self

    def set_state_thresholds(self, thresholds: dict):
        self.spec.state_thresholds.update(thresholds)
        return self

    # -- pod building (used by server-side runtime handlers & tests) -------
    def _container_env(self, extra_env: dict | None = None) -> list[dict]:
        env = [dict(e) for e in self.spec.env]
        for key, value in (extra_env or {}).items():
            env.append({"name": key, "value": str(value)})
        return env

    def to_pod_spec(self, command: list[str] | None = None,
                    extra_env: dict | None = None) -> dict:
        container = {
            "name": "main",
            "image": self.full_image_path(),
            "env": self._container_env(extra_env),
            "resources": self.spec.resources,
        }
        if command:
            container["command"] = command
        if self.spec.args:
            container["args"] = list(self.spec.args)
        if self.spec.workdir:
            container["workingDir"] = self.spec.workdir
        if self.spec.volume_mounts:
            container["volumeMounts"] = self.spec.volume_mounts
        pod_spec = {
            "containers": [container],
            "restartPolicy": "Never",
        }
        if self.spec.volumes:
            pod_spec["volumes"] = self.spec.volumes
        if self.spec.node_selector:
            pod_spec["nodeSelector"] = dict(self.spec.node_selector)
        if self.spec.tolerations:
            pod_spec["tolerations"] = self.spec.tolerations
        if self.spec.service_account:
            pod_spec["serviceAccountName"] = self.spec.service_account
        if self.spec.priority_class_name:
            pod_spec["priorityClassName"] = self.spec.priority_class_name
        return pod_spec
