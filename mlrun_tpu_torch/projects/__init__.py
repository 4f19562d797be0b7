"""Projects and their workflows — the port's copy of
``mlrun_tpu/projects``."""

from .pipelines import (  # noqa: F401
    PipelineContext,
    PipelineStep,
    load_and_run,
    pipeline_context,
)
from .project import (  # noqa: F401
    MlrunProject,
    ProjectMetadata,
    ProjectSpec,
    get_current_project,
    get_or_create_project,
    load_project,
    new_project,
)


def run_function(function, **kwargs):
    """Run a function through the active project."""
    return get_current_project().run_function(function, **kwargs)


def build_function(function, **kwargs):
    return get_current_project().build_function(function, **kwargs)


def deploy_function(function, **kwargs):
    return get_current_project().deploy_function(function, **kwargs)
