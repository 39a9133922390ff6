"""The JBU stages' and classifier's least time over their attributed device time, %."""
from perfbench.harness import flops, readers


def read(run):
    return readers.roofline(run, "jbu", flops.jbu_call)
