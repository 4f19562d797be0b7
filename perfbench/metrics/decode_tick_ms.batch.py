"""Median decode tick (the engine's tick ring) over the window."""

import readers


def read(run):
    return readers.decode_tick_ms(run)
