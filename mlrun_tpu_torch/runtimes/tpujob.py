"""The distributed-training runtime, sized in GPUs — the port's
counterpart of ``mlrun_tpu/runtimes/tpujob.py``.

The kind string stays ``tpujob`` and the class names stay the reference's,
so a function spec the reference serializes loads here (its TPU fields,
``accelerator_type`` / ``topology`` / ``chips_per_host``, are not read). A
run is a JobSet of ``num_slices`` replicated Jobs of ``nodes`` pods each,
every pod running ``gpus_per_node`` processes under ``torchrun`` on a node
of ``gpu_product`` (``k8s/jobset.build_jobset``); the run dict rides the
pod's env as the exec config. ``with_gpus`` and ``total_gpus`` take the
place of the reference's ``with_tpu_topology``, ``total_chips`` and
``hosts_per_slice``; ``with_tpu_topology`` raises ``TopologyError``.
"""

from __future__ import annotations

from ..common.runtimes_constants import RuntimeKinds
from ..config import K8S_DEFAULTS, RUN_FROM_ENV_COMMAND, run_config
from ..k8s.jobset import TopologyError
from ..model import RunObject
from .pod import KubeResource, KubeResourceSpec


class TpuJobSpec(KubeResourceSpec):
    _dict_fields = KubeResourceSpec._dict_fields + [
        "gpu_product", "nodes", "gpus_per_node", "num_slices",
        "max_restarts", "mesh_shape", "mesh_axes", "elastic",
    ]

    def __init__(self, gpu_product=None, nodes=None, gpus_per_node=None,
                 num_slices=None, max_restarts=None, mesh_shape=None,
                 mesh_axes=None, elastic=None, **kwargs):
        super().__init__(**kwargs)
        self.gpu_product = gpu_product or K8S_DEFAULTS["gpu_product"]
        # None = the default geometry (one node of 8 GPUs); an explicit 0
        # is kept so the typed TopologyError fires at JobSet build instead
        # of the bad value silently becoming the default
        self.nodes = nodes if nodes is not None else 1
        self.gpus_per_node = gpus_per_node if gpus_per_node is not None \
            else K8S_DEFAULTS["gpus_per_node"]
        self.num_slices = num_slices or 1
        # restart the whole JobSet on preemption; checkpoint-resume picks up
        self.max_restarts = max_restarts if max_restarts is not None else 3
        self.mesh_shape = mesh_shape
        self.mesh_axes = mesh_axes
        # elastic multi-slice: survive one slice's preemption by
        # resharding onto the survivors instead of a full JobSet restart
        self.elastic = bool(elastic)


class TpuJobRuntime(KubeResource):
    kind = RuntimeKinds.tpujob
    _is_remote = True
    _nested_fields = {**KubeResource._nested_fields, "spec": TpuJobSpec}

    def __init__(self, metadata=None, spec=None, status=None):
        super().__init__(metadata, spec, status)
        if not isinstance(self.spec, TpuJobSpec):
            self.spec = TpuJobSpec.from_dict(self.spec.to_dict())

    # -- GPU sizing --------------------------------------------------------
    def with_gpus(self, gpus_per_node: int | None = None,
                  gpu_product: str | None = None, nodes: int | None = None,
                  num_slices: int | None = None):
        """Declare the run's size, e.g. ``fn.with_gpus(8, nodes=2)`` for
        two 8-GPU nodes (16 torchrun processes); ``num_slices`` replicates
        the node group (one Job each)."""
        if gpus_per_node is not None:
            self.spec.gpus_per_node = gpus_per_node
        if gpu_product:
            self.spec.gpu_product = gpu_product
        if nodes is not None:
            self.spec.nodes = nodes
        if num_slices is not None:
            self.spec.num_slices = num_slices
        return self

    def with_tpu_topology(self, *args, **kwargs):
        """TPU slice shapes: a GPU run is sized with :meth:`with_gpus`."""
        raise TopologyError(
            "the port sizes a tpujob in GPUs: use with_gpus(gpus_per_node, "
            "gpu_product, nodes, num_slices) instead of "
            "with_tpu_topology(accelerator, topology, num_slices)")

    def with_mesh(self, shape: dict | None = None, axes: list | None = None):
        """Declare the default logical mesh for the auto-trainer, e.g.
        ``with_mesh({"data": 2, "fsdp": 8})``."""
        if shape:
            self.spec.mesh_shape = dict(shape)
        if axes:
            self.spec.mesh_axes = list(axes)
        return self

    def with_elastic(self, elastic: bool = True):
        """Opt the run into elastic multi-slice training: on a slice
        preemption the service submits only a replacement slice while
        the survivors reshard and keep training. The run's handler
        should pass an :class:`~mlrun_tpu_torch.training.ElasticGuard` to
        ``Trainer.fit`` and a retry policy with ``max_retries`` > 0 (the
        slice-replacement budget)."""
        self.spec.elastic = bool(elastic)
        return self

    def with_preemptible(self, spot: bool = True):
        if spot:
            self.spec.node_selector["cloud.google.com/gke-spot"] = "true"
        else:
            self.spec.node_selector.pop("cloud.google.com/gke-spot", None)
        return self

    @property
    def total_gpus(self) -> int:
        return (self.spec.nodes * self.spec.gpus_per_node
                * self.spec.num_slices)

    def full_image_path(self, image: str | None = None) -> str:
        return image or self.spec.image or K8S_DEFAULTS["image"]

    # -- execution ---------------------------------------------------------
    def _run(self, runobj: RunObject, execution) -> dict:
        raise RuntimeError(
            "the tpujob runtime provisions GPU nodes via the service — "
            "configure MLT_DBPATH, or pass local=True to execute the handler "
            "in-process on locally visible devices")

    def generate_jobset(self, runobj: RunObject, extra_env: dict | None = None,
                        command: list[str] | None = None) -> dict:
        """Build the JobSet resource for this run: the pod's program
        (``command``, default the port's CLI ``python3 -m mlrun_tpu_torch
        run --from-env``) under torchrun, with the run dict in the
        exec-config env."""
        import json

        from ..k8s.jobset import build_jobset

        env = {
            run_config("exec_config_env"): json.dumps(runobj.to_dict(),
                                                      default=str),
            "MLT_DBPATH": run_config("dbpath") or "",
        }
        env.update(extra_env or {})
        pod_spec = self.to_pod_spec(
            command=command or list(RUN_FROM_ENV_COMMAND),
            extra_env=env)
        name = f"{runobj.metadata.name}-{runobj.metadata.uid[:8]}"
        return build_jobset(
            name=name,
            namespace=K8S_DEFAULTS["namespace"],
            pod_spec=pod_spec,
            gpu_product=self.spec.gpu_product,
            nodes=self.spec.nodes,
            gpus_per_node=self.spec.gpus_per_node,
            num_slices=self.spec.num_slices,
            max_restarts=self.spec.max_restarts,
            elastic=bool(getattr(self.spec, "elastic", False)),
            labels={
                "mlrun-tpu/project": runobj.metadata.project,
                "mlrun-tpu/uid": runobj.metadata.uid,
                "mlrun-tpu/name": runobj.metadata.name,
                "mlrun-tpu/class": self.kind,
            },
        )
