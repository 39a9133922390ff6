"""Kernel launches per image in the traced calls."""
from perfbench.harness.readers import launches_per_image as read  # noqa: F401
