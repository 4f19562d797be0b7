"""95th percentile of the request ledger's queue_wait phase over the
requests due in the window."""

import readers


def read(run):
    return readers.queue_wait_p95_ms(run)
