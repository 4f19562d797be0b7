"""Framework plumbing shared by the port's adapters — counterpart of
``mlrun_tpu/frameworks/_common``: the structured callbacks and the artifact
plans. A producer selects the applicable plans and runs them inside the
run context."""

from .callbacks import (  # noqa: F401
    Callback,
    CallbackList,
    CheckpointCallback,
    EarlyStoppingCallback,
    EvalPlanCallback,
    FunctionCallback,
    MetricsLoggingCallback,
    TensorBoardCallback,
)
from .plans import (  # noqa: F401
    ArtifactPlan,
    CalibrationCurvePlan,
    ConfusionMatrixPlan,
    DEFAULT_CLASSIFICATION_PLANS,
    DEFAULT_REGRESSION_PLANS,
    FeatureImportancePlan,
    ResidualsPlan,
    ROCCurvePlan,
    produce_artifacts,
)
