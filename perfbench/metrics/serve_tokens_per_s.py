"""Output tokens the engine emitted in the window over the window's
seconds."""

import readers


def read(run):
    return readers.served_tokens_per_s(run)
