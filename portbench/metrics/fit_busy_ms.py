"""Device ms per call launched inside the scan-to-map builds' line and
plane fits (program span ``scan_match.fit``: the neighbour gathers and
``fit_line_planes`` / ``fit_plane_planes``)."""
from portbench.harness import spans

FIT = {"scan_match.solve": ("scan_match.fit",)}


def read(run):
    return spans.span_ms(run, "busy_ms", FIT)
