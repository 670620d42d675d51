"""Correspondence searches (port of ``cooper_mapper_tpu/ops/neighbors.py``).

``corner_pairs`` and ``surf_triples`` run the races of ``ops/races.py``
(LaserOdometry.cpp:358-497); ``knn_search`` runs the k-NN of ``ops/knn.py``
(ScanMatch.cpp:97-132).  The JAX package picks between Pallas kernels and
dense XLA searches with ``resolve_backend``; here the tensors' device picks:
a CUDA tensor launches the CUDA kernels, a CPU tensor runs their plain
versions.  The kernels bound the ragged last reference tile themselves, so
the reference is not padded to a tile multiple (the JAX package's
``_pad_ref_arrays`` has no counterpart).  The JAX package's dense ``knn``
and ``knn_chunked`` are ``ops.knn.knn_plain`` here, which chunks itself.

Queries are ``[B, Q, 3]``; the reference ``Cloud`` is shared (xyz ``[M, 3]``)
or per problem (xyz ``[B, M, 3]``).  Returned indices are int32 in
``[0, M)``.

``COOPER_PALLAS_FUSED=1`` routes ``corner_pairs`` / ``surf_triples`` through
the one-launch ``races.fused_races`` under the JAX package's gate
(``_fused_tile_q``): M rounded up to 128 at most 8192, Q a multiple of 128.
It is off by default, as in the JAX package.  On every query whose nearest
reference point is valid, both routes give the same selections.

``query_chunk > 0`` (``OdometryConfig.nn_query_chunk``) runs a CPU search in
query chunks of that size, padded like the JAX package's
``_chunked_queries``, so that the plain versions' distance tile is at most
``[b, query_chunk, M]``.  The card's kernels hold no such tile and ignore
it.

``q_list`` / ``r_list`` (``races.valid_list`` of the query mask and of the
reference's mask, each ``(order, count)``) let the races walk only the valid
queries and reference points (``ops/races.py``).  Every valid query gets the
same indices and validity as without lists; an invalid one gets indices 0
and ``valid`` False.  The fused route takes no lists.
"""

from __future__ import annotations

import os

import torch

from ..utils.cloud import Cloud
from . import knn as _knn
from . import races


def take_ref(values, idx, shared: bool):
    """Reference field at int32 indices [B, Q]: values [M, ...] when the
    reference is shared, [B, M, ...] when it is per problem -> [B, Q, ...].
    Indices come from the races, so they lie in [0, M)."""
    idx = idx.long()
    if shared:
        return values[idx]
    if values.dim() == 2:
        return torch.gather(values, 1, idx)
    return torch.gather(values, 1, idx[..., None].expand(-1, -1, values.shape[-1]))


def fused_route(n_queries: int, n_ref: int) -> bool:
    """True when a search of ``n_queries`` per problem against ``n_ref``
    reference points takes the fused kernel: the JAX package's
    ``_fused_tile_q`` gate, with M rounded up to 128 as its padding does."""
    if os.environ.get("COOPER_PALLAS_FUSED", "0") != "1":
        return False
    return -(-n_ref // 128) * 128 <= 8192 and n_queries % 128 == 0


def _chunked_queries(search, q_xyz, query_chunk: int, q_list=None):
    """``search(chunk, chunk_list)`` over query chunks of ``query_chunk``
    (the last padded with far queries at 1e6, as the JAX package pads),
    outputs [B, Q] joined along the query axis.  ``chunk_list`` is the walk
    list of the chunk's slice of ``q_list``'s mask (padding not valid), or
    None without ``q_list``."""
    Q = q_xyz.shape[-2]
    pad = (-Q) % query_chunk
    q_mask = races.list_mask(q_list)
    if pad:
        q_xyz = torch.cat([q_xyz, q_xyz.new_full((q_xyz.shape[0], pad, 3), 1e6)], dim=1)
        if q_mask is not None:
            q_mask = torch.nn.functional.pad(q_mask, (0, pad))
    chunk_list = lambda s: (None if q_mask is None
                            else races.valid_list(q_mask[:, s:s + query_chunk].contiguous()))
    parts = [search(q_xyz[:, s:s + query_chunk].contiguous(), chunk_list(s))
             for s in range(0, Q + pad, query_chunk)]
    return tuple(torch.cat(p, dim=1)[:, :Q] for p in zip(*parts))


def _plain_chunks(q_xyz, query_chunk: int) -> bool:
    return bool(query_chunk) and q_xyz.device.type == "cpu" and q_xyz.shape[-2] > query_chunk


def corner_pairs(q_xyz, ref: Cloud, max_sq_dist: float, ring_span: float = 2.5,
                 query_chunk: int = 0, q_list=None, r_list=None):
    """Odometry corner correspondences (LaserOdometry.cpp:358-408).

    A = nearest reference corner; B = nearest corner on a different ring
    within ``ring_span`` rings of A's ring.  Returns (ia, ib, valid), [B, Q].
    """
    if _plain_chunks(q_xyz, query_chunk):
        return _chunked_queries(
            lambda qc, ql: corner_pairs(qc, ref, max_sq_dist, ring_span, q_list=ql,
                                        r_list=r_list), q_xyz, query_chunk, q_list)
    if fused_route(q_xyz.shape[-2], ref.capacity):
        ia, da, ib, db = races.fused_races(q_xyz, ref.xyz, ref.ring, ref.mask, False,
                                           ring_span)
        return ia, ib, (da < max_sq_dist) & (db < max_sq_dist)
    ia, da = races.nn1(q_xyz, ref.xyz, ref.mask, q_list, r_list)
    ring_a = take_ref(ref.ring, ia, ref.xyz.dim() == 2)
    ib, db = races.nn1_masked(q_xyz, ring_a, ia, ref.xyz, ref.ring, ref.mask,
                              "adj", ring_span, q_list, r_list)
    return ia, ib, (da < max_sq_dist) & (db < max_sq_dist)


def surf_triples(q_xyz, ref: Cloud, max_sq_dist: float, ring_span: float = 2.5,
                 query_chunk: int = 0, q_list=None, r_list=None):
    """Odometry surface correspondences (LaserOdometry.cpp:421-497).

    A = nearest surf point; B = nearest other surf point on A's ring;
    C = nearest surf point on a different ring within ``ring_span``.
    Returns (ia, ib, ic, valid), [B, Q].
    """
    if _plain_chunks(q_xyz, query_chunk):
        return _chunked_queries(
            lambda qc, ql: surf_triples(qc, ref, max_sq_dist, ring_span, q_list=ql,
                                        r_list=r_list), q_xyz, query_chunk, q_list)
    if fused_route(q_xyz.shape[-2], ref.capacity):
        ia, da, ib, db, ic, dc = races.fused_races(q_xyz, ref.xyz, ref.ring, ref.mask,
                                                   True, ring_span)
    else:
        ia, da = races.nn1(q_xyz, ref.xyz, ref.mask, q_list, r_list)
        ring_a = take_ref(ref.ring, ia, ref.xyz.dim() == 2)
        ib, db, ic, dc = races.bc_races(q_xyz, ring_a, ia, ref.xyz, ref.ring,
                                        ref.mask, ring_span, q_list, r_list)
    valid = (da < max_sq_dist) & (db < max_sq_dist) & (dc < max_sq_dist)
    return ia, ib, ic, valid


def knn_search(q_xyz, r_xyz, r_mask, k: int):
    """k-NN for the scan-to-map searches, any ``1 <= k <= M``: (idx [B, Q, k]
    int32, sq_dist [B, Q, k]) ascending by (distance, index).  The JAX
    package's ``chunk`` and ``backend`` arguments have no counterpart: the
    plain version picks its own chunks, and the device picks the path."""
    return _knn.knn(q_xyz, r_xyz, r_mask, k)
