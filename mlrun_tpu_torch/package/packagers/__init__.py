"""Per-type-family packagers — the port's copy of
``mlrun_tpu/package/packagers/`` (default, standard library, numpy,
pandas), with a torch family in place of the reference's jax family."""

from .default import DefaultPackager  # noqa: F401
from .numpy_packagers import (  # noqa: F401
    NumpyArrayDictPackager,
    NumpyArrayListPackager,
    NumpyArrayPackager,
    NumpyScalarPackager,
)
from .pandas_packagers import (  # noqa: F401
    PandasDataFramePackager,
    PandasSeriesPackager,
)
from .python_standard_library import (  # noqa: F401
    BytesPackager,
    CollectionPackager,
    DataclassPackager,
    DatetimePackager,
    PathPackager,
    PrimitivePackager,
)
from .torch_packagers import (  # noqa: F401
    TorchTensorPackager,
    TorchTreePackager,
)

DEFAULT_PACKAGERS = (
    # highest priority first: specific families before generic fallbacks
    PandasDataFramePackager,
    PandasSeriesPackager,
    NumpyArrayPackager,
    NumpyScalarPackager,
    NumpyArrayDictPackager,
    NumpyArrayListPackager,
    TorchTensorPackager,
    TorchTreePackager,
    DataclassPackager,
    DatetimePackager,
    PathPackager,
    BytesPackager,
    PrimitivePackager,
    CollectionPackager,
)
