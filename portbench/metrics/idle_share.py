"""Percent of the traced window in which the card ran nothing."""
from portbench.harness.readers import idle_share as read  # noqa: F401
