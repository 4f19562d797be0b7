"""Prefix-cache hits over queries counted over the window (engine stats
prefix_hits / prefix_queries)."""

import readers


def read(run):
    return readers.prefix_hit_rate(run)
