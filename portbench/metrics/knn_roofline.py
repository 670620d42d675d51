"""Percent of the k-NN kernels' device time (csrc/knn_lists.cuh, the select
routes and their merge) that the card would need at its peak for the
searches' work, counted from the inputs (harness/roofline.knn_bound_s)."""
from portbench.harness.readers import roofline

KERNELS = ("knn_kernel", "knn_select_kernel", "knn_radix_kernel", "merge_first_k")


def read(run):
    return roofline(run, "knn", KERNELS)
