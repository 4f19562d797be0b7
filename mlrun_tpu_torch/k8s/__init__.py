"""Kubernetes manifests of the port: the GPU JobSet builder."""

from .jobset import (  # noqa: F401
    TopologyError,
    build_jobset,
    build_serving_jobset,
)
