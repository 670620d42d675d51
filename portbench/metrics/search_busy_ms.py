"""Device ms per call launched inside the searches' program spans: the
odometry's refresh blocks (``odometry.refresh``: warps, the race kernels,
the gathers) or the scan-to-map builds' k-NN (``scan_match.search``)."""
from portbench.harness import spans

SEARCH = {"odometry.solve": ("odometry.refresh",), "scan_match.solve": ("scan_match.search",)}


def read(run):
    return spans.span_ms(run, "busy_ms", SEARCH)
