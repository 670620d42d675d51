"""Brute-force correspondence searches of the plain reference.

Every search forms the whole [query, reference] distance tile of a block
of problems and reduces it.  The distance is the one the program's
searches define, ``(|q|^2 - 2 q.r) + |r|^2`` with ``q.r = (qx*rx + qy*ry) +
qz*rz``, each product and sum one f32 operation in that order; an invalid
reference point carries ``|r|^2 = BIG``; ties go to the smaller index.
Queries ``[B, Q, 3]``, references per problem ``[B, M, 3]``.

``tf32=True`` computes the cross term ``q.r`` as a TF32 matrix product
forms it (each coordinate rounded to TF32's 10-bit mantissa, the products
summed in f32), the norms in f32: the benchmark's control, the distance
tile in the precision below the configuration's float32.
"""

from __future__ import annotations

import torch

BIG = 1.0e12
RING_INVALID = 1.0e9
# distances per block of problems ([b, q, M] f32 and its temporaries)
TILE_ELEMS = 1 << 26


def _sq_norm(p):
    return p[..., 0] * p[..., 0] + p[..., 1] * p[..., 1] + p[..., 2] * p[..., 2]


def tf32_round(x):
    """``x`` rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero, as the tensor cores convert their inputs), held in f32."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def sq_dist(q, r, rn, tf32: bool = False):
    """[b, Q, 3] x [b, M, 3] (+ |r|^2 [b, M]) -> [b, Q, M]."""
    qn = _sq_norm(q)
    if tf32:
        q, r = tf32_round(q), tf32_round(r)
    qx, qy, qz = (q[..., i, None] for i in range(3))
    rx, ry, rz = (r[..., None, :, i] for i in range(3))
    d = qx * rx
    d = d + qy * ry
    d = d + qz * rz
    return (d * -2.0 + qn[..., None]) + rn[..., None, :]


def _blocks(B, Q, M):
    """(problem slice, query slice) blocks of at most TILE_ELEMS distances."""
    per_q = max(1, TILE_ELEMS // M)
    if per_q >= Q:
        step = max(1, per_q // Q)
        return [(slice(s, min(B, s + step)), slice(0, Q)) for s in range(0, B, step)]
    return [(slice(b, b + 1), slice(s, min(Q, s + per_q)))
            for b in range(B) for s in range(0, Q, per_q)]


def _argmin(d):
    i = torch.argmin(d, dim=-1)
    return i.to(torch.int32), torch.gather(d, -1, i[..., None])[..., 0]


def odometry_races(q, r_xyz, r_mask, r_ring, ring_span: float, with_same: bool,
                   tf32: bool = False):
    """The odometry searches (LaserOdometry.cpp:358-497): A, the nearest
    point; then, against A's stored ring, C, the nearest point on a different
    ring within ``ring_span`` rings, and with ``with_same`` B, the nearest
    other point on A's ring.  Returns (ia, da, ic, dc[, ib, db]) [B, Q]."""
    B, Q, _ = q.shape
    M = r_xyz.shape[1]
    rn = torch.where(r_mask, _sq_norm(r_xyz), torch.full_like(r_mask, BIG, dtype=torch.float32))
    ringf = torch.where(r_mask, r_ring.to(torch.float32),
                        torch.full_like(r_mask, RING_INVALID, dtype=torch.float32))
    n_out = 6 if with_same else 4
    outs = [torch.empty((B, Q), dtype=torch.int32 if k % 2 == 0 else torch.float32,
                        device=q.device) for k in range(n_out)]
    cols = torch.arange(M, device=q.device, dtype=torch.int32)
    for bs, qs in _blocks(B, Q, M):
        d = sq_dist(q[bs, qs], r_xyz[bs], rn[bs], tf32)
        ia, da = _argmin(d)
        # A's ring as stored (for an invalid A: its stored ring, as the program reads it)
        ra = torch.gather(r_ring[bs], 1, ia.long()).to(torch.float32)
        rd = torch.abs(ringf[bs][:, None, :] - ra[..., None])
        ic, dc = _argmin(torch.where((rd > 0.0) & (rd <= ring_span), d, BIG))
        res = [ia, da, ic, dc]
        if with_same:
            same = (ringf[bs][:, None, :] == ra[..., None]) & (cols != ia[..., None])
            res += list(_argmin(torch.where(same, d, BIG)))
        for k, v in enumerate(res):
            outs[k][bs, qs] = v
    return tuple(outs)


def _ordered_bits(d):
    """int64 keys in [-2^31, 2^31) that order like the f32 values ``d``
    (negative values included): a negative value's magnitude bits are
    flipped."""
    b = d.contiguous().view(torch.int32)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b).to(torch.int64)


def knn(q, r_xyz, r_mask, k: int, tf32: bool = False):
    """The k reference points of least distance, ascending by (distance,
    index): (idx [B, Q, k] int32, sq_dist [B, Q, k] f32)."""
    B, Q, _ = q.shape
    M = r_xyz.shape[1]
    rn = torch.where(r_mask, _sq_norm(r_xyz), torch.full_like(r_mask, BIG, dtype=torch.float32))
    idx = torch.empty((B, Q, k), dtype=torch.int32, device=q.device)
    dist = torch.empty((B, Q, k), dtype=torch.float32, device=q.device)
    cols = torch.arange(M, device=q.device, dtype=torch.int64)
    for bs, qs in _blocks(B, Q, M):
        d = sq_dist(q[bs, qs], r_xyz[bs], rn[bs], tf32)
        key = (_ordered_bits(d) << 32) | cols
        top = torch.topk(key, k, dim=-1, largest=False, sorted=True).values
        i = top & 0xFFFFFFFF
        idx[bs, qs] = i.to(torch.int32)
        dist[bs, qs] = torch.gather(d, -1, i)
    return idx, dist
