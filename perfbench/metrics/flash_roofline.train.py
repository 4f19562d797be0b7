"""Bound time of the traced flash forward and backward launches over their
device time, in percent."""

import readers


def read(run):
    return readers.flash_roofline(run)
