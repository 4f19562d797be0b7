"""The API's pydantic schemas — the port's copy of
``mlrun_tpu/common/schemas`` (accelerators as GPUs: ``k8s.py``)."""

from .base import ObjectKind, ObjectMetadata, ObjectSpec, ObjectStatus  # noqa: F401
from .background_task import BackgroundTask, BackgroundTaskState  # noqa: F401
from .client_spec import ClientSpec  # noqa: F401
from .function import FunctionRecord, FunctionState  # noqa: F401
from .project import ProjectOut, ProjectRecord, ProjectState  # noqa: F401
from .run import RetryPolicy, RunIdentifier, RunRecord  # noqa: F401
from .schedule import ScheduleKinds, ScheduleRecord  # noqa: F401
from .artifact import ArtifactRecord  # noqa: F401
from .model_endpoint import ModelEndpoint  # noqa: F401
from .alert import AlertConfigRecord, AlertSeverity, AlertState  # noqa: F401
from .datastore_profile import (  # noqa: F401
    DatastoreProfile,
    DatastoreProfileCreate,
)
from .events import Event, EventKind  # noqa: F401
from .feature_store import (  # noqa: F401
    Entity,
    Feature,
    FeatureSetRecord,
    FeatureSetSpec,
    FeatureVectorRecord,
    FeatureVectorSpec,
)
from .k8s import NodeSelector, Resources  # noqa: F401
from .notification import (  # noqa: F401
    Notification,
    NotificationKind,
    NotificationSeverity,
    NotificationStatus,
)
from .pagination import PaginatedResponse, PaginationInfo  # noqa: F401
from .runtime_resource import (  # noqa: F401
    RuntimeResource,
    RuntimeResourcesOutput,
)
from .secret import (  # noqa: F401
    AuthSecretData,
    SecretKeysData,
    SecretProviderName,
    SecretsData,
)
from .workflow import (  # noqa: F401
    WorkflowSpec,
    WorkflowState,
    WorkflowStatusOut,
)
