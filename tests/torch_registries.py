"""Both packages' process-wide metric registries, left as a test module
found them. A parity test that runs the reference's engines or loops
adds series to ``mlrun_tpu.obs.REGISTRY``, and they would outlive the
module. The reference's own continuous-tuning test reads that whole
registry into a time-series store of bounded size, so series left by an
earlier file in the same process can crowd out the ones it needs.

Import the fixture into a test module to arm it there::

    from tests.torch_registries import registries_left_as_found  # noqa: F401
"""

from __future__ import annotations

import pytest

from mlrun_tpu import obs as jobs
from mlrun_tpu_torch import obs as tobs

REGISTRIES = (jobs.REGISTRY, tobs.REGISTRY)


def _series_keys(registry) -> dict:
    return {name: set(metric._series)
            for name, metric in list(registry._metrics.items())}


@pytest.fixture(scope="module", autouse=True)
def registries_left_as_found():
    """When the module ends, remove every series its tests created."""
    before = [_series_keys(registry) for registry in REGISTRIES]
    yield
    for registry, kept in zip(REGISTRIES, before):
        for name, keys in _series_keys(registry).items():
            metric = registry.get(name)
            for key in keys - kept.get(name, set()):
                metric.remove(**dict(zip(metric.labelnames, key)))
