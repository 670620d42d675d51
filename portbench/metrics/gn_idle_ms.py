"""Card idle ms per call put down to the GN iterations' program spans: the
gaps between a call's device activities that began while the host was
inside ``gn.residuals``, ``gn.normal_eqs`` or ``gn.update``."""
from portbench.harness import spans

GN = {root: spans.GN for root in ("odometry.solve", "scan_match.solve")}


def read(run):
    return spans.span_ms(run, "idle_ms", GN)
