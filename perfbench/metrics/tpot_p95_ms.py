"""95th percentile over requests completed in the window of (completion -
first token) / (tokens - 1)."""

import readers


def read(run):
    return readers.tpot_p95_ms(run)
