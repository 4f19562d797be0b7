"""Process start to the first timed request or step: import, kernel load,
weights from the seed, warm-up."""


def read(run):
    return run["setup_s"]
