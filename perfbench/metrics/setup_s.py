"""Seconds from the process start to the first timed call."""


def read(run):
    return run.setup_s
