"""Share of the traced window with no kernel running on the device."""

import readers


def read(run):
    return readers.idle_share(run)
