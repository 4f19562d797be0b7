"""Training — counterpart of ``mlrun_tpu/training``: the trainer
(``Trainer``, ``make_train_step``, ``make_optimizer``) on one device or
a mesh, data streams and device prefetch, MFU accounting, checkpoints,
preemption and elastic slices.
"""

from .checkpoint import CheckpointManager  # noqa: F401
from .data import (  # noqa: F401
    DevicePrefetchIterator,
    array_token_stream,
    synthetic_token_stream,
    text_file_stream,
)
from .elastic import ElasticGuard, SliceEvent  # noqa: F401
from .mfu import ThroughputTracker, chip_peak_flops, mfu  # noqa: F401
from .preemption import PreemptionGuard  # noqa: F401
from .train import (  # noqa: F401
    TrainConfig,
    Trainer,
    TrainState,
    init_train_state,
    make_optimizer,
    make_train_step,
)
