"""The decode ticks' FLOPs in the window over its seconds and the bf16
peak, in percent."""

import readers


def read(run):
    return readers.decode_mfu(run)
