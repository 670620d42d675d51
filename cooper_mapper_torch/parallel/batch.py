"""Sharded and bucketed batch solves (port of ``cooper_mapper_tpu/parallel/batch.py``).

Three parts, as in the JAX package:

- ``sharded_odometry_solve`` / ``sharded_scan_match``: pure data
  parallelism.  Each rank solves its block of the batch with the port's
  batch solver (the race and k-NN kernels on the card) and the blocks are
  all-gathered, so every rank returns the whole batch.
- ``bucket_plan`` / ``bucketed_odometry_solve``: a heterogeneous batch on
  one device, each problem truncated to a capacity bucket of its valid
  counts and every bucket signature solved as a homogeneous batch.  The
  plan is host bookkeeping after one host read, and equals the JAX
  package's plan.
- ``sharded_pose_graph_optimize``: the LM with its edges split over the
  ranks; the per-edge blocks stay on their rank and the collectives sum
  what the JAX package's ``psum`` sums (``ops/pose_graph.lm_loop``).

Nothing here compiles: where the JAX package caches a jitted function per
configuration, the port calls its eager solvers directly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import OdometryConfig, PoseGraphConfig, ScanMatchConfig
from ..ops import odometry as odo_ops
from ..ops import pose_graph as pg
from ..ops import scan_match as sm_ops
from ..utils.cloud import Cloud
from . import mesh as mesh_lib


def _refs(refs, mesh):
    """Shared references (xyz [M, 3]) are replicated; per-problem ones
    (xyz [B, M, 3]) are sharded with the batch."""
    if refs[0].xyz.ndim == 2:
        return mesh_lib.replicated(refs, mesh)
    return mesh_lib.shard_batch(refs, mesh)


def sharded_odometry_solve(sharp, flat, last_corner, last_surf, x0, cfg: OdometryConfig,
                           mesh):
    """Batch-parallel scan-to-scan solves over the mesh: (x [B, 6], GNState
    of B), whole on every rank.  The query clouds and x0 carry a leading
    batch dimension divisible by the mesh size; the references are shared
    or per problem, as ``batch_odometry_solve`` takes them."""
    sharp, flat, x0 = mesh_lib.shard_batch((sharp, flat, x0), mesh)
    last_corner, last_surf = _refs((last_corner, last_surf), mesh)
    return mesh_lib.gather_batch(
        odo_ops.batch_odometry_solve(sharp, flat, last_corner, last_surf, x0, cfg), mesh)


def sharded_scan_match(corner, surf, ref_corner, ref_surf, x0, cfg: ScanMatchConfig, mesh,
                       chunk: int = 512):
    """Batch-parallel scan-to-map solves over the mesh: the
    ``ScanMatchResult`` of the whole batch on every rank.  A shared map
    (xyz [M, 3]) is replicated on every rank; per-problem maps shard with
    the batch."""
    corner, surf, x0 = mesh_lib.shard_batch((corner, surf, x0), mesh)
    ref_corner, ref_surf = _refs((ref_corner, ref_surf), mesh)
    return mesh_lib.gather_batch(
        sm_ops.batch_scan_match(corner, surf, ref_corner, ref_surf, x0, cfg, chunk), mesh)


# ---------------------------------------------------------------------------
# Capacity-bucketed heterogeneous dispatch: distinct problems carry distinct
# cloud sizes, and padding each to the batch's largest wastes race work on
# the small ones.  Every problem is truncated to the next capacity bucket of
# its valid counts, the problems of one bucket signature solve as one
# homogeneous batch, and the results go back in input order.
# ---------------------------------------------------------------------------


def _bucket_cap(n: int, granule: int) -> int:
    """Smallest bucket >= n: granule doublings (granule, 2g, 4g, ...) keep
    the number of signatures logarithmic in the size spread."""
    cap = granule
    while cap < n:
        cap *= 2
    return cap


def bucket_plan(sharp, flat, ref_c, ref_s, granule: int = 512, chunk: int = 256):
    """Dispatch plan for ``bucketed_odometry_solve``: ONE host read (valid
    counts and front-packedness), then bookkeeping.  Returns
    ``(front_packed, dispatches)``, each dispatch ``(caps, take_n, members,
    idx)``: the four clouds' bucket capacities, the dispatch's batch size,
    its problems and their indices repeat-padded to ``take_n``.

    The plan depends only on the valid counts, so it serves every solve of
    the same problem set (fresh x0s): pass it back as ``plan=``.  Small
    signatures coalesce upward (any below chunk / 4 members merges into the
    element-wise max with the next one, visited smallest cost first); tails
    dispatch at the next multiple of 32; where the bucketed plan's padded
    work is not below 0.75 of one homogeneous plan at the element-wise max
    caps, that plan is taken instead.  Bookkeeping identical to the JAX
    package's, so the two plans are equal."""
    B = sharp.mask.shape[0]
    clouds = (sharp, flat, ref_c, ref_s)
    counts = torch.stack([c.mask.sum(-1) for c in clouds], dim=1)          # [B, 4]
    packed = torch.stack([torch.all(c.mask == (torch.arange(c.capacity, device=c.mask.device)
                                                [None, :] < n[:, None]))
                          for c, n in zip(clouds, counts.unbind(1))])
    got = torch.cat([counts.reshape(-1), packed.to(counts.dtype)]).cpu().numpy()
    counts, front_packed = got[:4 * B].reshape(B, 4), bool(got[4 * B:].all())
    caps_full = tuple(c.capacity for c in clouds)
    sig = np.stack(
        [[min(_bucket_cap(int(n), granule), full)
          for n, full in zip(row, caps_full)] for row in counts]
    )                                                        # [B, 4]
    order: dict = {}
    for p in range(B):
        order.setdefault(tuple(int(v) for v in sig[p]), []).append(p)

    csz = min(chunk, B)
    min_members = max(1, csz // 4)
    sigs = sorted(order.items(), key=lambda kv: int(np.prod(kv[0])))
    coalesced: list = []
    for caps, members in sigs:
        if coalesced and len(coalesced[-1][1]) < min_members:
            prev_caps, prev_members = coalesced.pop()
            caps = tuple(max(a, b) for a, b in zip(prev_caps, caps))
            members = prev_members + members
        coalesced.append((caps, members))
    if len(coalesced) > 1 and len(coalesced[-1][1]) < min_members:
        caps_a, mem_a = coalesced.pop()
        caps_b, mem_b = coalesced.pop()
        coalesced.append(
            (tuple(max(a, b) for a, b in zip(caps_a, caps_b)), mem_b + mem_a)
        )

    def chunked(groups):
        out = []
        for caps, members in groups:
            s0 = 0
            while s0 < len(members):
                rem = len(members) - s0
                take_n = csz if rem >= csz else min(csz, -(-rem // 32) * 32)
                sl = members[s0:s0 + take_n]
                idx = np.resize(np.asarray(sl, np.int32), take_n)  # repeat-pad
                out.append((caps, take_n, sl, idx))
                s0 += take_n
        return out

    # a race-work proxy (query cap x reference cap, padded dispatch sizes
    # included); the JAX package calibrated the 0.75 margin on its chip,
    # where a predicted 0.89 plan ran 6% slower than the flat one
    cost = lambda caps: caps[0] * caps[2] + caps[1] * caps[3]
    bucketed = chunked(coalesced)
    flat_caps = tuple(int(np.max(sig[:, i])) for i in range(sig.shape[1]))
    flat = chunked([(flat_caps, list(range(B)))])
    work_b = sum(n * cost(caps) for caps, n, _, _ in bucketed)
    work_f = sum(n * cost(caps) for caps, n, _, _ in flat)
    dispatches = bucketed if work_b < 0.75 * work_f else flat
    return front_packed, tuple(dispatches)


def _compact_rows(c: Cloud, cap: int) -> Cloud:
    """``utils/cloud.compact`` of every row of a batched cloud: valid points
    stably to the front, the first ``cap`` kept."""
    order = torch.argsort((~c.mask).to(torch.int8), dim=-1, stable=True)[:, :cap]
    take = lambda a: torch.take_along_dim(a, order[..., None] if a.ndim == 3 else order, 1)
    return Cloud(take(c.xyz), take(c.mask), take(c.ring), take(c.rel_time))


def bucketed_odometry_solve(sharp, flat, ref_c, ref_s, x0, cfg: OdometryConfig,
                            granule: int = 512, chunk: int = 256, plan=None,
                            with_states: bool = True):
    """Heterogeneous batched scan-to-scan solves by capacity buckets.

    Every cloud is batched (xyz [B, N, 3]) at any capacity; the valid counts
    decide each problem's bucket signature (``bucket_plan``).  Each dispatch
    selects its rows (a slice when they are consecutive, ``index_select``
    otherwise), truncates every cloud to its bucket capacity (a slice when
    the clouds are front-packed, else ``_compact_rows``), solves, and the
    results go back in input order: each problem solved as it would be alone
    at its bucket capacities.  ``plan`` skips the host read.
    ``with_states=False`` returns (x, None); eager PyTorch computes the
    states all the same (there is no dead-code elimination), so it only
    skips gathering them."""
    if plan is None:
        plan = bucket_plan(sharp, flat, ref_c, ref_s, granule, chunk)
    front_packed, dispatches = plan

    def trunc(c: Cloud, cap: int) -> Cloud:
        if front_packed:
            return mesh_lib.tree_map(lambda t: t[:, :cap].contiguous(), c)
        return _compact_rows(c, cap)

    out_members: list = []
    out_x: list = []
    out_st: list = []
    for caps, take_n, sl, idx in dispatches:
        contiguous = (
            len(sl) == take_n
            and sl[-1] - sl[0] == take_n - 1
            and all(b - a == 1 for a, b in zip(sl, sl[1:]))
        )
        if contiguous:
            take = lambda t: t[sl[0]:sl[0] + take_n]
        else:
            rows = torch.from_numpy(idx).to(x0.device)
            take = lambda t: t.index_select(0, rows)
        sel = lambda c, cap: trunc(mesh_lib.tree_map(take, c), cap)
        x, st = odo_ops.batch_odometry_solve(
            sel(sharp, caps[0]), sel(flat, caps[1]), sel(ref_c, caps[2]), sel(ref_s, caps[3]),
            take(x0), cfg)
        out_members.append(sl)
        out_x.append(x[:len(sl)])
        if with_states:
            out_st.append(mesh_lib.tree_map(lambda a: a[:len(sl)], st))
    perm = torch.from_numpy(np.argsort(np.concatenate(out_members))).to(x0.device)
    x_out = torch.cat(out_x)[perm]
    if not with_states:
        return x_out, None
    fields = {f.name: torch.cat([getattr(s, f.name) for s in out_st])[perm]
              for f in dataclasses.fields(out_st[0])}
    return x_out, dataclasses.replace(out_st[0], **fields)


# ---------------------------------------------------------------------------
# Edge-sharded pose-graph LM: each rank assembles its block of edges; the
# gradient, the cost, and the dense Hessian or the CG's node-diagonal blocks
# and Hessian-vector products are summed over the ranks; the solve is
# replicated.
# ---------------------------------------------------------------------------


def sharded_pose_graph_optimize(graph: pg.PoseGraph, cfg: PoseGraphConfig, mesh):
    """LM with edge-sharded assembly; the edge capacity must divide over the
    mesh.  Returns (graph', diagnostics), the same on every rank.

    ``cfg.solver == "dense"``: each rank scatters its edges' blocks into a
    dense [6N, 6N] Hessian; H, g and the cost are all-reduced and every rank
    factors the sum (``cholesky_ex``, the step zeroed where it fails).
    ``cfg.solver == "cg"``: the per-edge 6x6 blocks stay on their rank, and
    only [N, 6]-sized quantities cross: the gradient, the node-diagonal
    preconditioner blocks and one Hessian-vector product per CG iteration,
    all-reduced before the damping term is added, where the JAX package's
    ``psum`` sits.

    The candidate's cost is the all-reduce of each rank's edge cost; the
    JAX package's dense path assembles H again only to read that cost, so
    the number is the same.  Like ``ops/pose_graph.optimize`` it reads
    nothing back to the host; over one rank every all-reduce is the
    identity and the result is ``optimize``'s, bit for bit."""
    E = graph.edge_i.shape[0]
    if E % mesh.size:
        raise ValueError(f"edge capacity {E} does not divide over {mesh.size} ranks")
    graph = mesh_lib.replicated(graph, mesh)
    per = E // mesh.size
    mine = slice(mesh.rank * per, (mesh.rank + 1) * per)
    local = dataclasses.replace(
        graph, edge_i=graph.edge_i[mine], edge_j=graph.edge_j[mine],
        edge_T=graph.edge_T[mine], edge_info=graph.edge_info[mine],
        edge_mask=graph.edge_mask[mine])
    out, diag = pg.lm_loop(local, cfg, reduce=lambda t: mesh_lib.all_reduce(t, mesh))
    return dataclasses.replace(graph, poses=out.poses), diag
