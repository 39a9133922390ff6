"""512² tiles completed in the window per second of it."""
from perfbench.harness.readers import tiles_per_s as read  # noqa: F401
