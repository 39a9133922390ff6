"""One call's model operations over its median latency, over the bf16 peak, %."""
from perfbench.harness.readers import step_mfu_per_call as read  # noqa: F401
