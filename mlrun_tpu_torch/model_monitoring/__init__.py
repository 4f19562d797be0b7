"""Model monitoring — the port's copy of ``mlrun_tpu/model_monitoring``:
drift metrics and histogram sketches (``metrics``), the endpoint metric
series (``tsdb``), the monitoring event stream and the per-adapter traffic
monitor (``stream_processing``), the monitoring applications
(``applications``), and the endpoint controller, its writer and the
continuous fine-tune→canary→promote loop (``controller``). Only the
endpoint pipeline's frame-building steps import pandas."""

from .applications import (  # noqa: F401
    ApplicationResult,
    HistogramDataDriftApplication,
    LatencyApplication,
    ModelMonitoringApplicationBase,
    MonitoringContext,
)
from .controller import (  # noqa: F401
    ContinuousTuningController,
    ModelMonitoringWriter,
    MonitoringApplicationController,
)
from .metrics import (  # noqa: F401
    FixedHistogram,
    hellinger_distance,
    kl_divergence,
    psi,
    total_variance_distance,
)
from .stream_processing import (  # noqa: F401
    AdapterTrafficMonitor,
    EventStreamProcessor,
    get_monitoring_parquet_dir,
    get_monitoring_stream,
)
