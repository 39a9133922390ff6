"""Median latency of the window's calls, from due to label maps on the host, ms."""
from perfbench.harness import readers


def read(run):
    return readers.latency_ms(run, 50)
