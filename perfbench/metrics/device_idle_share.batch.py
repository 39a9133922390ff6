"""Share of the time inside the traced calls in which no device operation ran, %."""
from perfbench.harness.readers import device_idle_share as read  # noqa: F401
