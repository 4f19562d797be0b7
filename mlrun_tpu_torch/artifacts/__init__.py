"""Artifacts — the port's copy of ``mlrun_tpu/artifacts``: the artifact
model, the manager that logs artifacts into the run db, and the dataset,
model, plot, chart and table artifacts."""

from .base import Artifact, ArtifactMetadata, ArtifactSpec, LinkArtifact  # noqa: F401
from .dataset import DatasetArtifact, update_dataset_meta  # noqa: F401
from .manager import (  # noqa: F401
    ArtifactManager,
    ArtifactProducer,
    artifact_types,
    dict_to_artifact,
)
from .model import ModelArtifact, get_model  # noqa: F401
from .plots import ChartArtifact, PlotArtifact, TableArtifact  # noqa: F401
