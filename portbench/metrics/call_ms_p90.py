"""90th percentile of the window's call times, ms: the host clock around the
solve entry, ending in a synchronize."""
from portbench.harness.readers import call_ms_p90 as read  # noqa: F401
