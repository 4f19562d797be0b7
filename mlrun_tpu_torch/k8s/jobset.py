"""GKE JobSet spec builder for GPU runs — the port's counterpart of
``mlrun_tpu/k8s/jobset.py``.

A run is a **JobSet** (jobset.x-k8s.io) of ``num_slices`` replicated
Indexed Jobs of ``nodes`` pods each, one pod per GPU node, where every pod
runs the same program under ``torchrun``: ``gpus_per_node`` processes per
pod, one per GPU. torchrun's static rendezvous replaces the reference's
MEGASCALE environment: ``MASTER_ADDR`` is pod 0 of the first Job through
the headless service (``subdomain``), ``NNODES`` / ``NPROC_PER_NODE`` size
the world, and ``NODE_RANK`` is the pod's completion index within its
Job (``MLT_SLICE_ID`` the Job's index; the node's global rank is
``MLT_SLICE_ID * nodes + NODE_RANK``). torchrun hands each process its
global ``RANK``, which ``execution.is_logging_worker`` reads.
"""

from __future__ import annotations

import copy

from ..config import COMPILE_CACHE_ENV

JOBSET_API_VERSION = "jobset.x-k8s.io/v1alpha2"

# marks a JobSet as a SERVING replica (the pod fleet's lifecycle applies)
SERVING_ANNOTATION = "mlrun-tpu/serving"

# the replicated Job's name (the reference's)
JOB_NAME = "slice"
GPU_RESOURCE = "nvidia.com/gpu"
GPU_PRODUCT_SELECTOR = "nvidia.com/gpu.product"
MASTER_PORT = 29500
SLICE_ID_ENV = "MLT_SLICE_ID"
_COMPLETION_INDEX = ("metadata.annotations"
                     "['batch.kubernetes.io/job-completion-index']")
_JOB_INDEX = "metadata.annotations['jobset.sigs.k8s.io/job-index']"


class TopologyError(ValueError):
    """Invalid node geometry (zero, negative or non-integer ``nodes`` or
    ``gpus_per_node``), raised at build time instead of producing a
    JobSet the cluster would park forever."""


def _positive(name: str, value) -> int:
    try:
        number = int(value)
    except (TypeError, ValueError) as exc:
        raise TopologyError(f"bad {name} '{value}'") from exc
    if number <= 0 or number != value:
        raise TopologyError(f"{name} must be a positive integer, got "
                            f"{value}")
    return number


def torchrun_command(nodes: int, no_python: bool = False) -> list:
    """The container command: ``torchrun`` over the pod's env, with the
    program and its arguments as the container's ``args`` (a script and
    its arguments; an executable with ``no_python``)."""
    flag = "--no-python " if no_python else ""
    return ["/bin/sh", "-c",
            'exec torchrun --nnodes="$NNODES" '
            '--nproc_per_node="$NPROC_PER_NODE" '
            f'--node_rank="$(({SLICE_ID_ENV} * {nodes} + NODE_RANK))" '
            '--master_addr="$MASTER_ADDR" --master_port="$MASTER_PORT" '
            f'{flag}"$@"', "torchrun"]


def build_jobset(name: str, namespace: str, pod_spec: dict, *,
                 gpu_product: str, nodes: int = 1, gpus_per_node: int = 8,
                 num_slices: int = 1, max_restarts: int = 0,
                 labels: dict | None = None, annotations: dict | None = None,
                 suspend: bool = False, elastic: bool = False) -> dict:
    """Build the JobSet dict for a GPU run.

    One replicated Job named 'slice' with ``num_slices`` replicas; each Job
    is Indexed with parallelism = completions = ``nodes``; every pod
    requests ``gpus_per_node`` GPUs on a ``gpu_product`` node and runs the
    main container's program under torchrun: its ``args`` as a script and
    its arguments, or, when it has a ``command``, that command (torchrun's
    ``--no-python``) followed by the ``args``.

    ``elastic`` marks a multi-slice run that survives losing a slice: the
    ``mlrun-tpu/elastic`` annotation declares the intent, and the
    failurePolicy restart budget is floored at ``num_slices``.
    """
    nodes = _positive("nodes", nodes)
    gpus_per_node = _positive("gpus_per_node", gpus_per_node)
    num_slices = _positive("num_slices", num_slices)
    labels = dict(labels or {})
    labels.setdefault("app.kubernetes.io/managed-by", "mlrun-tpu")
    annotations = dict(annotations or {})
    if elastic:
        annotations["mlrun-tpu/elastic"] = "true"
        max_restarts = max(int(max_restarts), int(num_slices))

    pod_spec = copy.deepcopy(pod_spec)
    pod_spec["subdomain"] = name  # headless service for host discovery
    node_selector = pod_spec.setdefault("nodeSelector", {})
    node_selector[GPU_PRODUCT_SELECTOR] = gpu_product

    containers = pod_spec.get("containers", [])
    if containers:
        main = containers[0]
        limits = main.setdefault("resources", {}).setdefault("limits", {})
        limits[GPU_RESOURCE] = gpus_per_node
        ports = main.setdefault("ports", [])
        ports.append({"containerPort": MASTER_PORT, "name": "coordinator"})
        command = list(main.get("command") or [])
        main["args"] = command + list(main.get("args") or [])
        main["command"] = torchrun_command(nodes, no_python=bool(command))
        env = main.setdefault("env", [])
        env.extend([
            {"name": "MASTER_ADDR",
             "value": f"{name}-{JOB_NAME}-0-0.{name}"},
            {"name": "MASTER_PORT", "value": str(MASTER_PORT)},
            {"name": "NNODES", "value": str(nodes * num_slices)},
            {"name": "NPROC_PER_NODE", "value": str(gpus_per_node)},
            {"name": "NODE_RANK",
             "valueFrom": {"fieldRef": {"fieldPath": _COMPLETION_INDEX}}},
            {"name": SLICE_ID_ENV,
             "valueFrom": {"fieldRef": {"fieldPath": _JOB_INDEX}}},
        ])

    job_template = {
        "spec": {
            "parallelism": nodes,
            "completions": nodes,
            "backoffLimit": 0,
            "completionMode": "Indexed",
            "template": {
                "metadata": {"labels": labels},
                "spec": pod_spec,
            },
        }
    }

    return {
        "apiVersion": JOBSET_API_VERSION,
        "kind": "JobSet",
        "metadata": {
            "name": name,
            "namespace": namespace,
            "labels": labels,
            "annotations": annotations,
        },
        "spec": {
            "suspend": suspend,
            "failurePolicy": {"maxRestarts": max_restarts},
            "replicatedJobs": [
                {"name": JOB_NAME, "replicas": num_slices,
                 "template": job_template}
            ],
        },
    }


def build_serving_jobset(name: str, namespace: str, pod_spec: dict, *,
                         gpu_product: str, nodes: int = 1,
                         gpus_per_node: int = 8,
                         compile_cache_dir: str | None = None,
                         serve_port: int = 8080,
                         labels: dict | None = None,
                         annotations: dict | None = None) -> dict:
    """Build the JobSet for ONE serving replica (one engine per JobSet,
    scaled by submitting / deleting whole JobSets):

    - ``SERVING_ANNOTATION`` marks it for the pod fleet's state machine;
    - the readiness probe hits ``/readyz``, which gates on warmth, so k8s
      never routes to a cold pod;
    - a ``preStop`` hook calls ``/__drain__`` so an eviction drains the
      in-flight requests before the kubelet sends SIGTERM;
    - ``compile_cache_dir`` rides in as ``COMPILE_CACHE_ENV`` so the
      replacement pod loads its kernel library from the shared cache
      instead of running nvcc.
    """
    annotations = dict(annotations or {})
    annotations[SERVING_ANNOTATION] = "true"
    spec = build_jobset(name, namespace, pod_spec, gpu_product=gpu_product,
                        nodes=nodes, gpus_per_node=gpus_per_node,
                        num_slices=1, labels=labels, annotations=annotations)
    pod = (spec["spec"]["replicatedJobs"][0]["template"]["spec"]
           ["template"]["spec"])
    containers = pod.get("containers", [])
    if containers:
        main = containers[0]
        if compile_cache_dir:
            env = main.setdefault("env", [])
            env.append({"name": COMPILE_CACHE_ENV,
                        "value": str(compile_cache_dir)})
        main["readinessProbe"] = {
            "httpGet": {"path": "/readyz", "port": serve_port},
            "periodSeconds": 2,
            "failureThreshold": 3,
        }
        main.setdefault("lifecycle", {})["preStop"] = {
            "httpGet": {"path": "/__drain__", "port": serve_port},
        }
    return spec
