"""Odometry solves completed per second over the whole window (host clock)."""
from portbench.harness.readers import rate as read  # noqa: F401
