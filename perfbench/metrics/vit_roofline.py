"""The ViT tower's least time over its attributed device time, %."""
from perfbench.harness import flops, readers


def read(run):
    return readers.roofline(run, "vit", flops.vit_call)
