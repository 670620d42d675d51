"""Percent of the valid query points that became rows of the normal
equations: the program's ``rows`` (at ``gn.normal_eqs``) over the builds x
``query_points`` (at the solve's root span)."""
from portbench.harness.spans import match_share as read  # noqa: F401
