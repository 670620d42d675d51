"""Port vs JAX package: the odometry correspondence searches corner_pairs and
surf_triples, with a shared and a per-problem reference, and with a
reference capacity that is not a tile multiple (the JAX package pads it for
its Pallas kernels; the port's kernels bound the ragged tile themselves).

Contract: equal validity, equal indices for valid queries.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from cooper_mapper_tpu.ops import neighbors as jnb  # noqa: E402
from cooper_mapper_tpu.utils.cloud import Cloud as JCloud  # noqa: E402
from cooper_mapper_torch import bridge  # noqa: E402
from cooper_mapper_torch.ops import neighbors as tnb  # noqa: E402
from cooper_mapper_torch.utils.cloud import Cloud as TCloud  # noqa: E402

GATE, SPAN, R = 25.0, 2.5, 16


def _clouds(seed, B, Q, M):
    rng = np.random.RandomState(seed)
    q = rng.uniform(-8, 8, (B, Q, 3)).astype(np.float32)
    refs = []
    for _ in range(B):
        xyz = rng.uniform(-8, 8, (M, 3)).astype(np.float32)
        mask = rng.rand(M) > 0.1
        xyz[~mask] = 1e6
        refs.append(JCloud(jnp.asarray(xyz), jnp.asarray(mask),
                           jnp.asarray(rng.randint(0, R, M).astype(np.int32)),
                           jnp.zeros(M, jnp.float32)))
    return q, refs


def _stack(refs):
    cs = [bridge.cloud(r, "cpu") for r in refs]
    return TCloud(*(torch.stack([getattr(c, f) for c in cs])
                    for f in ("xyz", "mask", "ring", "rel_time")))


def _check(got, want):
    *gi, gok = [t.numpy() for t in got]
    *wi, wok = [np.asarray(t) for t in want]
    np.testing.assert_array_equal(gok, wok)
    assert gok.mean() > 0.3
    for a, b in zip(gi, wi):
        np.testing.assert_array_equal(a[gok], b[gok])


@pytest.mark.parametrize("M", [256, 300], ids=["tile-multiple", "needs-padding"])
@pytest.mark.parametrize("pallas", [False, True], ids=["dense", "pallas-interpret"])
def test_shared_reference(M, pallas, monkeypatch):
    if pallas:
        monkeypatch.setenv("COOPER_PALLAS_INTERPRET", "1")
        monkeypatch.setenv("COOPER_USE_PALLAS", "1")
    B, Q = 2, 128
    q, refs = _clouds(1, B, Q, M)
    ref_t = bridge.cloud(refs[0], "cpu")
    tc = tnb.corner_pairs(torch.from_numpy(q), ref_t, GATE, SPAN)
    ts = tnb.surf_triples(torch.from_numpy(q), ref_t, GATE, SPAN)
    for b in range(B):
        jc = jnb.corner_pairs(jnp.asarray(q[b]), refs[0], GATE, ring_span=SPAN, n_rings=R)
        js = jnb.surf_triples(jnp.asarray(q[b]), refs[0], GATE, ring_span=SPAN, n_rings=R)
        _check([t[b] for t in tc], jc)
        _check([t[b] for t in ts], js)


@pytest.mark.parametrize("M", [256, 300], ids=["tile-multiple", "needs-padding"])
def test_per_problem_reference(M):
    B, Q = 3, 128
    q, refs = _clouds(2, B, Q, M)
    ref_t = _stack(refs)
    tc = tnb.corner_pairs(torch.from_numpy(q), ref_t, GATE, SPAN)
    ts = tnb.surf_triples(torch.from_numpy(q), ref_t, GATE, SPAN)
    for b in range(B):
        jc = jnb.corner_pairs(jnp.asarray(q[b]), refs[b], GATE, ring_span=SPAN, n_rings=R)
        js = jnb.surf_triples(jnp.asarray(q[b]), refs[b], GATE, ring_span=SPAN, n_rings=R)
        _check([t[b] for t in tc], jc)
        _check([t[b] for t in ts], js)


def test_take_ref_gathers_both_layouts():
    xyz = torch.arange(24, dtype=torch.float32).reshape(8, 3)
    idx = torch.tensor([[0, 7], [3, 3]], dtype=torch.int32)
    shared = tnb.take_ref(xyz, idx, True)
    per = tnb.take_ref(torch.stack([xyz, xyz + 100]), idx, False)
    assert torch.equal(shared, xyz[idx.long()])
    assert torch.equal(per[0], xyz[idx[0].long()])
    assert torch.equal(per[1], xyz[idx[1].long()] + 100)


def _query_mask(seed, B, Q):
    return torch.from_numpy(np.random.RandomState(seed).rand(B, Q) < 0.6)


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per-problem"])
@pytest.mark.parametrize("query_chunk", [0, 50], ids=["whole", "query-chunks"])
def test_lists_keep_every_valid_querys_answer(shared, query_chunk):
    # with the walk lists: the same indices and validity on every valid
    # query as without them, indices 0 and valid False on the others; the
    # CPU's query chunks give the same
    from cooper_mapper_torch.ops import races

    B, Q, M = 3, 128, 300
    q, refs = _clouds(3, B, Q, M)
    ref = bridge.cloud(refs[0], "cpu") if shared else _stack(refs)
    q_mask = _query_mask(4, B, Q)
    qt = torch.from_numpy(q)
    qt[~q_mask] = 1e6
    lists = (races.valid_list(q_mask), races.valid_list(ref.mask))
    for search in (tnb.corner_pairs, tnb.surf_triples):
        whole = search(qt, ref, GATE, SPAN)
        listed = search(qt, ref, GATE, SPAN, query_chunk, *lists)
        assert whole[-1][q_mask].float().mean() > 0.3
        for w, got in zip(whole, listed):
            assert torch.equal(got[q_mask], w[q_mask])
            assert not got[~q_mask].any()
