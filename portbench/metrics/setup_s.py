"""Seconds from the process start to the end of the warm-up: imports, the
kernels' build or load, the input pool made on the card, the warm calls."""


def read(run):
    return run.setup_s
