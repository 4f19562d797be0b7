"""95th percentile of send time minus due time, every request due in the
window (the load generator's lag)."""

import readers


def read(run):
    return readers.generator_lag_p95_ms(run)
