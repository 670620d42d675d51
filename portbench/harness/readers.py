"""What the metric readers of ``portbench/metrics`` share: a reader is
``read(run) -> float | None`` over the run record of ``harness/cell.py``
(``solves``, ``window_s``, ``setup_s``, ``call_s``, and in a traced run
``trace`` and ``work``), and gives None where it finds nothing to read."""

from __future__ import annotations

import numpy as np


def rate(run):
    """Solves completed per second over the whole window."""
    return run.solves / run.window_s


def call_ms_p90(run):
    """90th percentile (linear) of the window's host-clock call times, ms."""
    return float(np.percentile(np.asarray(run.call_s) * 1e3, 90)) if run.call_s else None


def _calls(run):
    return run.trace["calls"] if run.trace and run.trace["calls"] else None


def launches_per_call(run):
    """Device activities (kernels, copies, fills) per traced call."""
    calls = _calls(run)
    return None if calls is None else sum(len(c) for c in calls) / len(calls)


def _own(name, kernels):
    return any(k in name for k in kernels)


def device_ms_per_call(run, kernels, own: bool):
    """Device ms per traced call in activities whose name holds one of
    ``kernels`` (``own``) or none of them; None where there are none."""
    calls = _calls(run)
    if calls is None:
        return None
    s = sum(t for c in calls for n, t in c if _own(n, kernels) == own)
    return s / len(calls) * 1e3 if s > 0 else None


def roofline(run, family: str, kernels):
    """Percent of the traced calls' time in ``kernels`` that the card would
    need at its peak for the work ``family`` of ``entry.bound_s``."""
    calls = _calls(run)
    if calls is None:
        return None
    t = sum(s for c in calls for n, s in c if _own(n, kernels))
    bound = sum(w.get(family, 0.0) for w in run.work)
    return 100.0 * bound / t if t > 0 and bound > 0 else None


def idle_share(run):
    """Percent of the traced window in which no device activity ran."""
    if not run.trace or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
