"""Bytes-bound time of csrc/paged_decode.cu's launches over their device
time in the trace, in percent."""

import readers


def read(run):
    return readers.paged_decode_roofline(run)
