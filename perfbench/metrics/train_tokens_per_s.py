"""Tokens of every optimizer step finished in the window over the window's
seconds, ended by a synchronise."""

import readers


def read(run):
    return readers.train_tokens_per_s(run)
