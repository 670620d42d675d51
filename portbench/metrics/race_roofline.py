"""Percent of the race kernels' device time (csrc/races.cu and its merge) that
the card would need at its peak for the searches' work, counted from the
inputs (harness/roofline.odometry_race_bound_s)."""
from portbench.harness.readers import roofline

KERNELS = ("nn1_kernel", "masked_kernel", "bc_races_kernel", "fused_races_kernel", "merge_min")


def read(run):
    return roofline(run, "races", KERNELS)
