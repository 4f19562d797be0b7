"""95th percentile time to first token, from when each request was due,
over every request due in the window."""

import readers


def read(run):
    return readers.ttft_p95_ms(run)
