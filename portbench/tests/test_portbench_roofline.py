"""The roofline shares' work is counted from the inputs: the port's split
plan and the clouds' padding do not move it."""

import torch

from cooper_mapper_torch.ops import races
from portbench.harness import roofline, spec
from portbench.inputs import pool
from portbench.tests.small import CELLS, small


def _args(cell_name):
    wl, cfg = small(cell_name)
    entry = spec.entry(wl["entry"])(cfg, wl["traffic"], 5, "cpu")
    _, gen = pool.generators(5, 1, "cpu")
    return entry, entry.feed(gen)[1]


def test_work_does_not_follow_the_split_plan(monkeypatch):
    for cell_name in CELLS[:2]:
        entry, args = _args(cell_name)
        before = entry.bound_s(args)
        monkeypatch.setattr(races, "SPLIT_BLOCKS_PER_SM", 64)
        monkeypatch.setattr(races, "_split_plan", lambda B, Q, M, n_sm, bq: (7, -(-M // 7)))
        assert entry.bound_s(args) == before
        monkeypatch.undo()


def test_work_counts_valid_pairs_only():
    g = torch.Generator().manual_seed(0)
    qm = torch.rand((4, 50), generator=g) > 0.5
    rm = torch.rand((4, 300), generator=g) > 0.5
    pad = lambda m, n: torch.cat([m, torch.zeros((m.shape[0], n), dtype=torch.bool)], -1)
    for kind in ("corner_search", "surf_search", "knn"):
        a = roofline.search_bound_s(kind, qm, rm, k=5)
        assert roofline.search_bound_s(kind, pad(qm, 77), pad(rm, 1000), k=5) == a
        pairs = float((qm.sum(-1).double() * rm.sum(-1).double()).sum())
        assert a >= pairs * roofline.OPS_PER_PAIR[kind] / roofline.FP32_PEAK_OPS


def test_odometry_bound_counts_every_refresh():
    entry, args = _args(CELLS[0])
    clouds, _ = args
    one = roofline.odometry_race_bound_s(clouds["sharp"]["mask"], clouds["flat"]["mask"],
                                         clouds["less_sharp"]["mask"],
                                         clouds["less_flat"]["mask"], 1)
    assert abs(entry.bound_s(args)["races"] - 5 * one) <= 1e-12 * one
