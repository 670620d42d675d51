"""Percent of the races' padded (query, reference) pairs that they walk:
the program's ``race_pairs_walked`` over ``race_pairs_padded``, counted
at the odometry's refresh blocks (``odometry.refresh``) in the span pass's
calls.  None where the program counts neither (a checkout before the
counters)."""
from portbench.harness import spans

SPAN = "odometry.refresh"


def read(run):
    p = spans.of(run)
    if p is None or not p["calls"]:
        return None
    count = lambda name: sum(c["counts"].get(SPAN, {}).get(name, 0) for c in p["calls"])
    padded = count("race_pairs_padded")
    return 100.0 * count("race_pairs_walked") / padded if padded > 0 else None
