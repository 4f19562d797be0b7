"""The feature store — the port's copy of ``mlrun_tpu/feature_store``
(host only, pandas throughout): feature sets and vectors, ingestion into
the datastore targets, offline merges and the online feature service."""

from .api import (  # noqa: F401
    OfflineVectorResponse,
    OnlineVectorService,
    get_offline_features,
    get_online_feature_service,
    ingest,
    preview,
)
from .feature_set import (  # noqa: F401
    Entity,
    Feature,
    FeatureSet,
    FeatureVector,
)
from .ingestion_service import (  # noqa: F401
    FeatureSetIngestStep,
    ingestion_service_function,
)
from .steps import apply_aggregations, apply_transforms  # noqa: F401
