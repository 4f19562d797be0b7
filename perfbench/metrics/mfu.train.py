"""The window's training FLOPs (6 a weight a token over the active weights,
plus causal attention) over its seconds and the bf16 peak, in percent."""

import readers


def read(run):
    return readers.train_mfu(run)
