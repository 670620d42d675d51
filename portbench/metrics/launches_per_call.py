"""Device activities per call of the solve entry (eager PyTorch dispatch),
from the profiler's trace of the traced calls."""
from portbench.harness.readers import launches_per_call as read  # noqa: F401
