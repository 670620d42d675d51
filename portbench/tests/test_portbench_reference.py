"""The plain reference against the port at CPU-sized problems (the test
imports both; the reference imports nothing of the port)."""

import pytest
import torch

from portbench.harness import cell, compare, spec
from portbench.inputs import pool
from portbench.reference import search
from portbench.tests.small import CELLS, small

torch.set_num_threads(1)


@pytest.mark.parametrize("cell_name", CELLS)
def test_reference_agrees_with_the_port(cell_name):
    """The port's answers (its plain searches on the CPU) and the
    reference's agree to the bit on every problem of two calls."""
    wl, cfg = small(cell_name)
    entry = spec.entry(wl["entry"])(cfg, wl["traffic"], 2**32 + 3, "cpu")
    _, gen = pool.generators(2**32 + 3, cell.CALL_STREAM, "cpu")
    problems, outputs = [], []
    for _ in range(2):
        p, args = entry.feed(gen)
        problems.append(p)
        outputs.append(entry.solve(args))
    picked, got = cell.sample(problems, outputs, 12, 1, "cpu")
    want = cell.reference(entry, picked, 6)
    values = compare.numbers(got, want)
    assert values["twist_gap_max"] == 0.0 and values["flag_mismatch_share"] == 0.0, values
    # and the solves did move the poses from their priors
    assert float(compare.gaps(got["x"], picked["x0"]).max()) > 1e-4


def _cloud(B, M, g):
    xyz = torch.randn((B, M, 3), generator=g) * 3.0
    mask = torch.rand((B, M), generator=g) > 0.25
    xyz = torch.where(mask[..., None], xyz, torch.tensor(1e6))
    return xyz, mask, torch.randint(0, 16, (B, M), generator=g, dtype=torch.int32)


def test_searches_equal_the_ports_plain_versions():
    from cooper_mapper_torch.ops import knn, races

    g = torch.Generator().manual_seed(2)
    q = torch.randn((3, 70, 3), generator=g) * 3.0
    r, m, ring = _cloud(3, 300, g)
    ia, da, ic, dc, ib, db = search.odometry_races(q, r, m, ring, 2.5, True)
    pa, pda = races.nn1_plain(q, r, m)
    ra = torch.gather(ring, 1, pa.long())
    want = (pa, pda) + races.bc_races_plain(q, ra, pa, r, ring, m, 2.5)
    for got, exp in zip((ia, da, ib, db, ic, dc), want):
        assert torch.equal(got, exp)
    for k in (1, 5, 9):
        assert all(torch.equal(a, b) for a, b in zip(search.knn(q, r, m, k),
                                                     knn.knn_plain(q, r, m, k)))


def test_knn_orders_ties_and_negative_distances_by_index():
    d = torch.tensor([[[2.0, -1.0, 0.5, -1.0, 2.0, 0.5]]])
    r = torch.zeros((1, 6, 3))
    key = (search._ordered_bits(d) << 32) | torch.arange(6)
    top = torch.topk(key, 6, dim=-1, largest=False).values & 0xFFFFFFFF
    assert top.tolist() == [[[1, 3, 2, 5, 0, 4]]]
    assert r.shape[1] == 6
