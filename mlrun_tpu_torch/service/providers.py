"""Execution-resource providers — the port's copy of
``mlrun_tpu/service/providers.py`` (reference analog:
server/api/utils/singletons/k8s.py K8sHelper + the fake local tier the
reference tests with K8sHelperMock, tests/api/conftest.py:208).

Providers decouple "what resource to create" from "where": the
``KubernetesProvider`` creates pods, JobSets and Services through the k8s
API (the ``kubernetes`` package is imported when a provider is built,
never at module import); the ``LocalProcessProvider`` runs a resource's
own container command (a ``tpujob``'s torchrun over ``python3 -m
mlrun_tpu_torch run --from-env``) as a child process, so the whole
submit -> pod -> run -> logs path works on one machine. Each verb fires
its ``provider.*`` chaos point first.

The kubernetes provider also creates the serving gateways' Deployments
(``service/deployments.py``) and the spark-operator's SparkApplication
(``runtimes/sparkjob.py``).
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading

from ..chaos import FaultPoints
from ..chaos import fire as chaos_fire
from ..common.runtimes_constants import (
    JobSetConditions,
    PodPhases,
    RunStates,
)
from ..config import K8S_DEFAULTS


# CRD kinds the kubernetes provider speaks: kind -> (group, version,
# plural); _CRD_BY_LOWER keys by the resource-id prefix
_CRD_KINDS = {
    "JobSet": ("jobset.x-k8s.io", "v1alpha2", "jobsets"),
    "SparkApplication": ("sparkoperator.k8s.io", "v1beta2",
                         "sparkapplications"),
}
_CRD_BY_LOWER = {k.lower(): v for k, v in _CRD_KINDS.items()}
# the port's CLI under any of the names a container command may give it
_CLI_HEADS = ("mlrun-tpu", "mlrun_tpu", "mlrun-tpu-torch")


def _extract_pod_spec(resource: dict) -> dict:
    if resource.get("kind") == "JobSet":
        return resource["spec"]["replicatedJobs"][0]["template"]["spec"][
            "template"]["spec"]
    if resource.get("kind") == "Deployment":
        return resource["spec"]["template"]["spec"]
    return resource.get("spec", resource)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _local_jobset_env(resource: dict, container: dict) -> dict:
    """A JobSet's pod env as its pod 0 of slice 0 on this machine: the
    field references (the completion and job indexes) read 0, and
    torchrun's rendezvous (the headless service's pod 0 in a cluster) is
    127.0.0.1 on a free port."""
    env = {}
    for item in container.get("env", []):
        if "valueFrom" in item and "value" not in item:
            env[item["name"]] = "0"
    if resource.get("kind") == "JobSet":
        env["MASTER_ADDR"] = "127.0.0.1"
        env["MASTER_PORT"] = str(_free_port())
    return env


def _process_tree(pid: int) -> list[int]:
    """``pid`` and every live descendant (parent links read from
    ``/proc/<pid>/stat``; just ``[pid]`` where that is unreadable)."""
    parents: dict[int, list[int]] = {}
    try:
        names = os.listdir("/proc")
    except OSError:
        return [pid]
    for name in names:
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat", "rb") as f:
                stat = f.read().decode(errors="replace")
            ppid = int(stat.rsplit(") ", 1)[1].split()[1])
        except (OSError, ValueError, IndexError):
            continue
        parents.setdefault(ppid, []).append(int(name))
    tree, todo = [], [pid]
    while todo:
        current = todo.pop()
        tree.append(current)
        todo.extend(parents.get(current, []))
    return tree


def signal_process_tree(pid: int, sig: int = 15):
    """Signal a local resource's whole process tree: the child's process
    group and each descendant's (torchrun starts every worker in a
    session of its own, so the child's group alone misses them)."""
    for member in _process_tree(pid):
        try:
            os.killpg(member, sig)
        except OSError:
            try:
                os.kill(member, sig)
            except OSError:
                pass


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except OSError:
        return False
    return True


def _proc_start_ticks(pid: int) -> int:
    """Kernel start time (jiffies since boot, /proc/<pid>/stat field 22) —
    a stable process identity that survives pid reuse. 0 when unavailable
    (non-linux), which degrades to pid-only liveness."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            stat = f.read().decode(errors="replace")
        return int(stat.rsplit(") ", 1)[1].split()[19])
    except (OSError, ValueError, IndexError):
        return 0



class Provider:
    """Creates/inspects/deletes execution resources."""

    kind = "base"

    def create(self, resource: dict, run_uid: str) -> str:
        raise NotImplementedError

    def state(self, resource_id: str) -> str:
        raise NotImplementedError

    def delete(self, resource_id: str):
        raise NotImplementedError

    def logs(self, resource_id: str, offset: int = 0) -> bytes:
        return b""


class LocalProcessProvider(Provider):
    """Runs the pod command as a local subprocess (dev/single-host mode)."""

    kind = "local-process"

    def __init__(self, db):
        self._db = db
        self._procs: dict[str, subprocess.Popen] = {}
        self._threads: dict[str, threading.Thread] = {}
        self._lock = threading.Lock()

    def create(self, resource: dict, run_uid: str) -> str:
        chaos_fire(FaultPoints.provider_create, kind=self.kind,
                   run_uid=run_uid, resource=resource)
        pod_spec = _extract_pod_spec(resource)
        container = pod_spec["containers"][0]
        env = dict(os.environ)
        for item in container.get("env", []):
            if "value" in item:
                env[item["name"]] = str(item["value"])
        env.update(_local_jobset_env(resource, container))
        # single-process resource = rank 0
        env.setdefault("MLT_WORKER_RANK", "0")
        # the pod's programs (torchrun, python3) from this interpreter's
        # environment first
        env["PATH"] = os.pathsep.join(
            p for p in (os.path.dirname(sys.executable), env.get("PATH"))
            if p)
        # execution happens in-process-tree: the container's own command,
        # the port's CLI as this interpreter's module
        command = list(container.get("command") or
                       ["mlrun-tpu-torch", "run", "--from-env"])
        if command[0] in _CLI_HEADS:
            command = [sys.executable, "-m", "mlrun_tpu_torch"] + command[1:]
        args = container.get("args", [])
        project = resource.get("metadata", {}).get("labels", {}).get(
            "mlrun-tpu/project", "")

        # its own session: delete() stops its process tree (torchrun's
        # agent and the workers it starts in sessions of their own)
        proc = subprocess.Popen(
            command + list(args), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, cwd=container.get("workingDir") or None,
            start_new_session=True)
        # fingerprint with the kernel start time so a recovered resource id
        # can never be confused with a recycled pid
        resource_id = f"proc-{proc.pid}-{_proc_start_ticks(proc.pid)}"
        with self._lock:
            self._procs[resource_id] = proc

        def pump():
            for line in proc.stdout:
                try:
                    self._db.store_log(run_uid, project, line)
                except Exception:  # noqa: BLE001
                    pass
            proc.wait()

        thread = threading.Thread(target=pump, daemon=True)
        thread.start()
        self._threads[resource_id] = thread
        return resource_id

    def state(self, resource_id: str) -> str:
        chaos_fire(FaultPoints.provider_state, kind=self.kind,
                   resource_id=resource_id)
        proc = self._procs.get(resource_id)
        if proc is None:
            # recovered resource from a previous service process: the Popen
            # handle is gone, but pid + start-time fingerprint tell us
            # whether the same process still runs (the run itself reports
            # its state over HTTP, so liveness is all the monitor needs)
            if self._recovered_alive(resource_id):
                return PodPhases.running
            return PodPhases.failed
        code = proc.poll()
        if code is None:
            return PodPhases.running
        return PodPhases.succeeded if code == 0 else PodPhases.failed

    def delete(self, resource_id: str):
        chaos_fire(FaultPoints.provider_delete, kind=self.kind,
                   resource_id=resource_id)
        proc = self._procs.pop(resource_id, None)
        if proc is not None:
            if proc.poll() is None:
                signal_process_tree(proc.pid)
            return
        if self._recovered_alive(resource_id):
            signal_process_tree(self._pid_of(resource_id)[0])

    @classmethod
    def _recovered_alive(cls, resource_id: str) -> bool:
        """True only when the pid is alive AND (when recorded) its kernel
        start time matches — a recycled pid never counts as the run."""
        pid, ticks = cls._pid_of(resource_id)
        if not pid or not _pid_alive(pid):
            return False
        return ticks == 0 or _proc_start_ticks(pid) == ticks

    @staticmethod
    def _pid_of(resource_id: str) -> tuple[int, int]:
        if resource_id.startswith("proc-"):
            parts = resource_id[5:].split("-")
            try:
                pid = int(parts[0])
                ticks = int(parts[1]) if len(parts) > 1 else 0
                return pid, ticks
            except ValueError:
                return 0, 0
        return 0, 0


class KubernetesProvider(Provider):
    """Creates real pods, JobSet and SparkApplication CRDs, Deployments
    and Services (requires the kubernetes package at construction)."""

    kind = "kubernetes"

    def __init__(self, namespace: str | None = None):
        import kubernetes  # gated import

        kubernetes.config.load_incluster_config() \
            if os.environ.get("KUBERNETES_SERVICE_HOST") \
            else kubernetes.config.load_kube_config()
        self._core = kubernetes.client.CoreV1Api()
        self._custom = kubernetes.client.CustomObjectsApi()
        self.namespace = namespace or K8S_DEFAULTS["namespace"]

    # the ONE registry of CRD kinds the provider speaks (create/state/
    # delete/list all read it): kind -> (group, version, plural).
    # SparkApplication is the spark-operator contract
    # (runtimes/sparkjob.py generate_spark_application)
    CRD_KINDS = _CRD_KINDS

    def create(self, resource: dict, run_uid: str) -> str:
        chaos_fire(FaultPoints.provider_create, kind=self.kind,
                   run_uid=run_uid, resource=resource)
        kind = resource.get("kind")
        if kind in self.CRD_KINDS:
            group, version, plural = self.CRD_KINDS[kind]
            self._custom.create_namespaced_custom_object(
                group, version, self.namespace, plural, resource)
            return f"{kind.lower()}/{resource['metadata']['name']}"
        if kind == "Deployment":
            # long-running gateway Deployments (service/deployments.py) —
            # replicas come from the function's min_replicas
            import kubernetes

            kubernetes.client.AppsV1Api(
                self._core.api_client).create_namespaced_deployment(
                self.namespace, resource)
            return f"deployment/{resource['metadata']['name']}"
        self._core.create_namespaced_pod(self.namespace, resource)
        return f"pod/{resource['metadata']['name']}"

    def create_service(self, manifest: dict) -> str:
        """Create/replace a Service (a gateway's, or a JobSet's headless
        service)."""
        import kubernetes

        name = manifest["metadata"]["name"]
        try:
            self._core.replace_namespaced_service(name, self.namespace,
                                                  manifest)
        except kubernetes.client.exceptions.ApiException as exc:
            if exc.status != 404:
                raise
            self._core.create_namespaced_service(self.namespace, manifest)
        return name

    def state(self, resource_id: str) -> str:
        chaos_fire(FaultPoints.provider_state, kind=self.kind,
                   resource_id=resource_id)
        kind, _, name = resource_id.partition("/")
        if kind == "deployment":
            import kubernetes

            dep = kubernetes.client.AppsV1Api(
                self._core.api_client).read_namespaced_deployment(
                name, self.namespace)
            status = dep.status
            if (getattr(status, "available_replicas", 0) or 0) >= 1:
                return PodPhases.running
            # "rolling out" against "dead": a deployment whose pods are
            # crash-looping still reports 0 available
            for cond in getattr(status, "conditions", None) or []:
                if (getattr(cond, "type", "") == "Progressing"
                        and getattr(cond, "status", "") == "False"):
                    return PodPhases.failed
            return PodPhases.pending
        if kind == "sparkapplication":
            group, version, plural = _CRD_BY_LOWER["sparkapplication"]
            obj = self._custom.get_namespaced_custom_object(
                group, version, self.namespace, plural, name)
            # spark-operator applicationState.state contract
            app_state = (obj.get("status", {})
                         .get("applicationState", {})
                         .get("state", "")).upper()
            return {
                "COMPLETED": PodPhases.succeeded,
                "FAILED": PodPhases.failed,
                "SUBMISSION_FAILED": PodPhases.failed,
                "FAILING": PodPhases.failed,
                "": PodPhases.pending,
                "NEW": PodPhases.pending,
                "SUBMITTED": PodPhases.pending,
                "PENDING_RERUN": PodPhases.pending,
            }.get(app_state, PodPhases.running)
        if kind == "jobset":
            group, version, plural = _CRD_BY_LOWER["jobset"]
            obj = self._custom.get_namespaced_custom_object(
                group, version, self.namespace, plural, name)
            run_state = JobSetConditions.to_run_state(
                obj.get("status", {}).get("conditions", []))
            return {
                RunStates.completed: PodPhases.succeeded,
                RunStates.error: PodPhases.failed,
                RunStates.pending: PodPhases.pending,
            }.get(run_state, PodPhases.running)
        pod = self._core.read_namespaced_pod(name, self.namespace)
        return pod.status.phase

    def delete(self, resource_id: str):
        chaos_fire(FaultPoints.provider_delete, kind=self.kind,
                   resource_id=resource_id)
        kind, _, name = resource_id.partition("/")
        crd = _CRD_BY_LOWER.get(kind)
        if crd:
            group, version, plural = crd
            self._custom.delete_namespaced_custom_object(
                group, version, self.namespace, plural, name)
        elif kind == "deployment":
            import kubernetes

            kubernetes.client.AppsV1Api(
                self._core.api_client).delete_namespaced_deployment(
                name, self.namespace)
            # the fronting Service shares the Deployment's name
            try:
                self._core.delete_namespaced_service(name, self.namespace)
            except kubernetes.client.exceptions.ApiException as exc:
                if exc.status != 404:
                    raise
        else:
            self._core.delete_namespaced_pod(name, self.namespace)

    # -- slice elasticity (docs/fault_tolerance.md "Elastic training") ------
    def slice_status(self, resource_id: str) -> dict:
        """Per-slice health of a multi-slice JobSet: ``{"failed_slices":
        [indices], "replicas": N}`` (empty dict for non-JobSet
        resources). The contract field is ``status.failedSlices`` — the
        fake cluster maintains it directly; a production deployment
        derives it from the JobSet controller's child-Job states (the
        stock ``replicatedJobsStatus`` carries counts, not indices, so a
        real watcher enumerates child Jobs ``<name>-slice-<i>``). This is
        what lets ``monitor_runs`` tell "one slice gone, job alive"
        (elastic replacement) from "job dead" (full resubmit)."""
        kind, _, name = resource_id.partition("/")
        if kind != "jobset":
            return {}
        group, version, plural = _CRD_BY_LOWER["jobset"]
        obj = self._custom.get_namespaced_custom_object(
            group, version, self.namespace, plural, name)
        status = obj.get("status", {}) or {}
        failed = status.get("failedSlices") or []
        jobs = obj.get("spec", {}).get("replicatedJobs") or [{}]
        replicas = int(jobs[0].get("replicas", 1) or 1)
        annotations = obj.get("metadata", {}).get("annotations") or {}
        return {"failed_slices": sorted(int(s) for s in failed),
                "replicas": replicas,
                # the with_elastic() opt-in, carried on the resource so
                # a restarted service still honors it
                "elastic": annotations.get("mlrun-tpu/elastic") == "true"}

    def replace_slice(self, resource_id: str, slice_index: int,
                      extra_env: dict | None = None) -> str:
        """Submit a replacement for ONE preempted slice of a live JobSet
        — the survivors keep running. ``extra_env`` (checkpoint-resume +
        compile-cache env) is upserted into the JobSet's pod template
        first, so the replacement pod joins warm; then the failed child
        Job is deleted and the JobSet controller recreates it from the
        updated template. Returns the child-Job name."""
        chaos_fire(FaultPoints.provider_replace_slice, kind=self.kind,
                   resource_id=resource_id, slice_index=slice_index)
        kind, _, name = resource_id.partition("/")
        if kind != "jobset":
            raise ValueError(
                f"slice replacement only applies to JobSets, not "
                f"'{resource_id}'")
        group, version, plural = _CRD_BY_LOWER["jobset"]
        if extra_env:
            obj = self._custom.get_namespaced_custom_object(
                group, version, self.namespace, plural, name)
            jobs = obj.get("spec", {}).get("replicatedJobs") or []
            for job in jobs:
                pod_spec = (job.get("template", {}).get("spec", {})
                            .get("template", {}).get("spec", {}))
                for container in pod_spec.get("containers", []):
                    env = container.setdefault("env", [])
                    for key, value in extra_env.items():
                        for existing in env:
                            if existing.get("name") == key:
                                existing["value"] = str(value)
                                break
                        else:
                            env.append({"name": key, "value": str(value)})
            self._custom.patch_namespaced_custom_object(
                group, version, self.namespace, plural, name,
                {"spec": {"replicatedJobs": jobs}})
        import kubernetes

        child = f"{name}-slice-{int(slice_index)}"
        kubernetes.client.BatchV1Api(
            self._core.api_client).delete_namespaced_job(
            child, self.namespace)
        return child

    def ensure_project_secret(self, project: str, secrets: dict) -> str:
        """Create/replace the project's k8s Secret and return its name."""
        import base64

        import kubernetes

        name = f"mlrun-tpu-secrets-{project}"
        body = kubernetes.client.V1Secret(
            metadata=kubernetes.client.V1ObjectMeta(
                name=name, labels={"mlrun-tpu/project": project}),
            data={k: base64.b64encode(str(v).encode()).decode()
                  for k, v in secrets.items()})
        try:
            self._core.replace_namespaced_secret(name, self.namespace, body)
        except kubernetes.client.exceptions.ApiException as exc:
            if exc.status != 404:
                raise
            self._core.create_namespaced_secret(self.namespace, body)
        return name

    def delete_project_secret(self, project: str):
        import kubernetes

        try:
            self._core.delete_namespaced_secret(
                f"mlrun-tpu-secrets-{project}", self.namespace)
        except kubernetes.client.exceptions.ApiException as exc:
            if exc.status != 404:
                raise

    def list_resources(self, class_label: str) -> list[tuple[str, str, str]]:
        """Discover live cluster resources by label selector (reference
        base.py:65,189 recovers handler state the same way). Returns
        (resource_id, run_uid, project) triples. Listing is PAGINATED via
        the k8s continue token so a large cluster can't blow one response
        (reference paginates the same way)."""
        selector = f"mlrun-tpu/class={class_label}"
        found = []
        token = None
        while True:
            pods = self._core.list_namespaced_pod(
                self.namespace, label_selector=selector, limit=500,
                _continue=token)
            for pod in pods.items:
                labels = pod.metadata.labels or {}
                found.append((f"pod/{pod.metadata.name}",
                              labels.get("mlrun-tpu/uid", ""),
                              labels.get("mlrun-tpu/project", "")))
            token = getattr(pods.metadata, "_continue", None) or getattr(
                pods.metadata, "continue_", None)
            if not token:
                break
        for crd_kind, (group, version, plural) in _CRD_KINDS.items():
            token = None
            while True:
                objs = self._custom.list_namespaced_custom_object(
                    group, version, self.namespace, plural,
                    label_selector=selector, limit=500,
                    **({"_continue": token} if token else {}))
                for obj in objs.get("items", []):
                    labels = obj.get("metadata", {}).get("labels", {})
                    found.append(
                        (f"{crd_kind.lower()}/{obj['metadata']['name']}",
                         labels.get("mlrun-tpu/uid", ""),
                         labels.get("mlrun-tpu/project", "")))
                token = objs.get("metadata", {}).get("continue")
                if not token:
                    break
        return [f for f in found if f[1]]

    def list_serving_jobsets(self) -> dict[str, dict]:
        """The observed world for control-plane reconciliation: every
        serving JobSet (``mlrun-tpu/serving`` annotation) actually on the
        cluster, name → manifest. A restarted ``ServingPodFleet`` diffs
        this against its replayed intent journal (docs/fault_tolerance.md
        "Control-plane crash recovery"). Paginated like
        :meth:`list_resources`."""
        from ..k8s.jobset import SERVING_ANNOTATION

        group, version, plural = _CRD_BY_LOWER["jobset"]
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


