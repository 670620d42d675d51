"""Device ms per call launched inside the GN iterations' program spans:
residuals and Jacobians (``gn.residuals``), normal equations
(``gn.normal_eqs``) and the 6x6 update (``gn.update``)."""
from portbench.harness import spans

GN = {root: spans.GN for root in ("odometry.solve", "scan_match.solve")}


def read(run):
    return spans.span_ms(run, "busy_ms", GN)
