"""The model's operations per second of the window over the bf16 peak, %."""
from perfbench.harness.readers import step_mfu as read  # noqa: F401
