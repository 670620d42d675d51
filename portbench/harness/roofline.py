"""The yardstick of the roofline shares: the card's peaks and the work of
the correspondence searches, counted from a cell's inputs.

The constants are a frozen copy of ``chip_smoke.py``'s, so that a
later change to the program's own smoke test cannot move the benchmark's
bound.  Work is counted from the query and reference masks that the cell
hands the program, over the searches that the algorithm's fixed schedule
runs, never from the program's launches, split plans or padded slots: a
share then reads the same work whatever kernel implements the search.
"""

from __future__ import annotations

import torch

# Published H100 SXM peaks (NVIDIA data sheet), at the full 700 W power
# limit: HBM3 bandwidth, and FP32 outside the tensor cores, 67 TFLOP/s
# counting an FMA as two operations.  The searches issue no FMA (their
# rounding must equal the plain versions'), so one FP32 operation takes one
# issue slot and their peak is half that: 132 SMs x 128 lanes x 1.98 GHz.
FP32_PEAK_OPS = 67e12 / 2
HBM_BYTES_PER_S = 3.35e12

# FP32 operations per (query, valid reference) pair that each search needs
# as a function, whatever implements it: 8 for d = (|q|^2 - 2 q.r) + |r|^2
# (3 mul, 2 add, 1 scale, 1 sub, 1 add) and 1 compare for race A's running
# minimum; the corner search adds race C's ring test and minimum (4), 13;
# the surf search adds B's (2) too, 15.  The k-NN: 8 for d and 1 compare
# against the k-th best (the insertions that follow a successful compare
# are left out).  The selects that keep (min, argmin) are left out, so each
# bound is a floor.  A route that runs a search as several races (nn1, then
# nn1_masked or bc_races, each computing d again) issues more than this.
OPS_PER_PAIR = {"corner_search": 13, "surf_search": 15, "knn": 9}


def _as_counts(mask):
    """Valid points per problem of a [B, N] mask, as float64 [B]."""
    return mask.sum(-1).to(torch.float64)


def search_bound_s(kind: str, q_mask, r_mask, k: int = 0, with_ring: bool = False,
                   n_out: int = 1) -> float:
    """Least seconds the card needs for one search of the B problems'
    valid queries against their valid reference points: the larger of the
    operations over FP32_PEAK_OPS and the bytes over HBM_BYTES_PER_S.

    q_mask [B, Q], r_mask [B, M] (per problem) or [M] (shared).  Bytes: each
    valid query (12) and valid reference point (12, and 4 for its ring)
    read once, and per valid query ``n_out`` (index, distance) pairs (8
    each) written, or k of them for the k-NN.
    """
    nq = _as_counts(q_mask)
    nr = _as_counts(r_mask)
    if r_mask.dim() == 1:
        nr = nr.expand_as(nq)
    pairs = float((nq * nr).sum())
    ops = pairs * OPS_PER_PAIR[kind]
    ref_bytes = float(nr.sum()) if r_mask.dim() == 2 else float(nr[0])
    out_pairs = k if kind == "knn" else n_out
    nbytes = (float(nq.sum()) * 12 + ref_bytes * (16 if with_ring else 12)
              + float(nq.sum()) * out_pairs * 8)
    return max(ops / FP32_PEAK_OPS, nbytes / HBM_BYTES_PER_S)


def odometry_race_bound_s(sharp_mask, flat_mask, corner_mask, surf_mask,
                          n_refresh: int) -> float:
    """Bound of the scan-to-scan solve's searches: at each of its
    ``n_refresh`` correspondence refreshes one corner search (sharp vs
    less_sharp: A, then C on the adjacent rings) and one surf search (flat
    vs less_flat: A, then B on A's ring and C on the adjacent rings)."""
    corner = search_bound_s("corner_search", sharp_mask, corner_mask, with_ring=True, n_out=2)
    surf = search_bound_s("surf_search", flat_mask, surf_mask, with_ring=True, n_out=3)
    return n_refresh * (corner + surf)


def knn_bound_s(corner_mask, surf_mask, ref_corner_mask, ref_surf_mask, k: int,
                n_builds: int) -> float:
    """Bound of the scan-to-map solve's k-NN: ``n_builds`` residual builds
    (one per GN iteration and one at the solved pose), each a corner and a
    surf search."""
    return n_builds * (search_bound_s("knn", corner_mask, ref_corner_mask, k=k)
                       + search_bound_s("knn", surf_mask, ref_surf_mask, k=k))
