"""The JobSet surface of the Kubernetes provider — the part of
``mlrun_tpu/service/providers.py`` the serving pod fleet
(``serving/podfleet.py``) drives: ``create`` / ``state`` / ``delete`` of a
JobSet custom object, ``list_serving_jobsets`` (the observed world a
restarted pod fleet reconciles against) and the ``_core`` CoreV1 client
the pod fleet reads pod phases through. Each verb fires its
``provider.*`` chaos point first.

The ``kubernetes`` package is imported when a provider is built, never at
module import, so the port imports without it (the card's machine has
none). Pods, Deployments, Services, secrets, slice replacement and the
local-process provider belong to the service (ROADMAP.md, item 14) and
raise ``not_ported``.
"""

from __future__ import annotations

import os

from ..chaos import FaultPoints, fire
from ..config import K8S_DEFAULTS

# the JobSet custom resource: (group, version, plural)
_JOBSET_CRD = ("jobset.x-k8s.io", "v1alpha2", "jobsets")


def jobset_phase(conditions: list) -> str:
    """A JobSet's pod phase from its status conditions (the reference's
    ``JobSetConditions.to_run_state`` mapped onto pod phases): Completed
    -> Succeeded, Failed -> Failed, Suspended -> Pending, else Running."""
    by_type = {c.get("type") for c in conditions or []
               if c.get("status") in (True, "True")}
    if "Completed" in by_type:
        return "Succeeded"
    if "Failed" in by_type:
        return "Failed"
    if "Suspended" in by_type:
        return "Pending"
    return "Running"


class KubernetesProvider:
    """Creates, reads and deletes JobSet custom objects (requires the
    kubernetes package at construction)."""

    kind = "kubernetes"

    def __init__(self, namespace: str | None = None):
        import kubernetes  # gated import

        kubernetes.config.load_incluster_config() \
            if os.environ.get("KUBERNETES_SERVICE_HOST") \
            else kubernetes.config.load_kube_config()
        self._core = kubernetes.client.CoreV1Api()
        self._custom = kubernetes.client.CustomObjectsApi()
        self.namespace = namespace or K8S_DEFAULTS["namespace"]

    @staticmethod
    def _crd(kind: str, verb: str):
        if str(kind).lower() != "jobset":
            from ..serving.resilience import not_ported

            raise not_ported(f"KubernetesProvider.{verb} of a '{kind}'", 14)
        return _JOBSET_CRD

    def create(self, resource: dict, run_uid: str) -> str:
        fire(FaultPoints.provider_create, kind=self.kind, run_uid=run_uid,
             resource=resource)
        kind = resource.get("kind")
        group, version, plural = self._crd(kind, "create")
        self._custom.create_namespaced_custom_object(
            group, version, self.namespace, plural, resource)
        return f"{kind.lower()}/{resource['metadata']['name']}"

    def state(self, resource_id: str) -> str:
        fire(FaultPoints.provider_state, kind=self.kind,
             resource_id=resource_id)
        kind, _, name = resource_id.partition("/")
        group, version, plural = self._crd(kind, "state")
        obj = self._custom.get_namespaced_custom_object(
            group, version, self.namespace, plural, name)
        return jobset_phase(obj.get("status", {}).get("conditions", []))

    def delete(self, resource_id: str):
        fire(FaultPoints.provider_delete, kind=self.kind,
             resource_id=resource_id)
        kind, _, name = resource_id.partition("/")
        group, version, plural = self._crd(kind, "delete")
        self._custom.delete_namespaced_custom_object(
            group, version, self.namespace, plural, name)

    def list_serving_jobsets(self) -> dict[str, dict]:
        """The observed world for control-plane reconciliation: every
        serving JobSet (``mlrun-tpu/serving`` annotation) on the cluster,
        name -> manifest, read page by page through the continue token."""
        from ..k8s.jobset import SERVING_ANNOTATION

        group, version, plural = _JOBSET_CRD
        found: dict[str, dict] = {}
        token = None
        while True:
            objs = self._custom.list_namespaced_custom_object(
                group, version, self.namespace, plural,
                limit=500, **({"_continue": token} if token else {}))
            for obj in objs.get("items", []):
                meta = obj.get("metadata", {})
                annotations = meta.get("annotations", {}) or {}
                if annotations.get(SERVING_ANNOTATION) != "true":
                    continue
                found[meta.get("name", "")] = obj
            token = objs.get("metadata", {}).get("continue")
            if not token:
                break
        found.pop("", None)
        return found
