"""Kubernetes resource schemas (reference analog:
mlrun/common/schemas/k8s.py), sized in GPUs: the port's copy of
``mlrun_tpu/common/schemas/k8s.py`` with the GPU fields the port's
``tpujob`` runtime carries (``gpu_product``, ``nodes``,
``gpus_per_node``) where the reference names a TPU accelerator and
topology."""

from __future__ import annotations

from typing import Optional

import pydantic


class Resources(pydantic.BaseModel):
    """Container resources; the accelerator resource is nvidia.com/gpu
    (the reference's google.com/tpu)."""

    cpu: Optional[str] = None
    memory: Optional[str] = None
    gpus: Optional[int] = None

    def to_k8s(self) -> dict:
        out: dict = {}
        if self.cpu:
            out["cpu"] = self.cpu
        if self.memory:
            out["memory"] = self.memory
        if self.gpus:
            out["nvidia.com/gpu"] = self.gpus
        return out


class NodeSelector(pydantic.BaseModel):
    """GPU node placement: the product a node carries and the geometry
    of the run (the reference's accelerator type and topology)."""

    gpu_product: Optional[str] = None  # e.g. NVIDIA-H100-80GB-HBM3
    nodes: Optional[int] = None
    gpus_per_node: Optional[int] = None

    def to_k8s(self) -> dict:
        out = {}
        if self.gpu_product:
            out["nvidia.com/gpu.product"] = self.gpu_product
        return out
