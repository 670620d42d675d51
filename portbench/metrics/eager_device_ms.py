"""Device ms per call in activities that are not the port's own CUDA kernels
(the eager GN, residuals, fits, twists and copies)."""
from portbench.harness.readers import device_ms_per_call


def read(run):
    return device_ms_per_call(run, run.port_kernels, own=False)
