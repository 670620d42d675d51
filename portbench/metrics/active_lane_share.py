"""Percent of the GN lane-steps that did work: the program's ``lane_steps``
(sum of ``iter_used``) over ``lanes`` x ``steps``, counted at the solve's
root span."""
from portbench.harness.spans import active_lane_share as read  # noqa: F401
