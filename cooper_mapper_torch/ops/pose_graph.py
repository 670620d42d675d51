"""SE(3) pose-graph optimization: Levenberg-Marquardt on the device
(port of ``cooper_mapper_tpu/ops/pose_graph.py``; the g2o backend of
solver_g2o.{h,cpp}: ``lm_var`` over SE3 nodes and edges).

Per-edge residuals and Jacobians (forward-mode autodiff on the se(3)
manifold, as ``jax.jacfwd`` in the JAX package), 6x6 block Hessians scattered
into a dense [6N, 6N] system (``solver="dense"``: Cholesky) or applied
matrix-free (``solver="cg"``: block-Jacobi preconditioned CG), diagonal LM
damping with accept / reject.  Node 0 is gauge-fixed (solver_g2o.cpp:51-63);
masks make the node and edge counts dynamic under a fixed capacity, and the
solve factors the whole capacity, inactive nodes included, as the JAX
package does.

Three things differ in form from the JAX package, not in result:

- Every scatter-add with repeated targets (the gradient, the dense blocks,
  the node-diagonal blocks, the Hessian-vector product) is a ``ScatterPlan``:
  the contributions stably sorted by target once per ``optimize`` and summed
  by ``torch.segment_reduce`` in index order.  ``index_add_`` would sum in no
  fixed order on the card, so a repeated run would not repeat its bits.
- ``torch.linalg.cholesky`` raises on a matrix that is not positive
  definite, where the JAX package's gives NaN.  ``cholesky_ex`` reports it on
  the device instead, and the step is set to zero there explicitly, which is
  what ``gn_nan_guard`` makes of JAX's NaN.
- The LM loop and the CG loop are Python loops of tensor ops with no host
  read: accept / reject, the lambda update and the CG freeze are selects.

The edge-sharded LM of ``parallel/batch.py`` runs these same functions on
each rank's block of edges, with ``reduce`` (identity here) summing the
gradient, the Hessian, its node-diagonal blocks, each Hessian-vector product
and the cost over the ranks where the JAX package's ``psum`` sums them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from ..config import PoseGraphConfig
from ..utils import se3


@dataclasses.dataclass
class PoseGraph:
    """Fixed-capacity pose graph.

    poses:    [N, 4, 4] node estimates
    node_mask:[N]
    edge_i/j: [E] int32 node indices
    edge_T:   [E, 4, 4] relative measurements (i -> j)
    edge_info:[E, 6] diagonal information (translation 3, rotation 3)
    edge_mask:[E]
    """

    poses: torch.Tensor
    node_mask: torch.Tensor
    edge_i: torch.Tensor
    edge_j: torch.Tensor
    edge_T: torch.Tensor
    edge_info: torch.Tensor
    edge_mask: torch.Tensor


def _eye4(n: int, device):
    return torch.eye(4, dtype=torch.float32, device=device).expand(n, 4, 4).clone()


def create(max_nodes: int, max_edges: int, device="cuda") -> PoseGraph:
    return PoseGraph(
        poses=_eye4(max_nodes, device),
        node_mask=torch.zeros(max_nodes, dtype=torch.bool, device=device),
        edge_i=torch.zeros(max_edges, dtype=torch.int32, device=device),
        edge_j=torch.zeros(max_edges, dtype=torch.int32, device=device),
        edge_T=_eye4(max_edges, device),
        edge_info=torch.ones(max_edges, 6, dtype=torch.float32, device=device),
        edge_mask=torch.zeros(max_edges, dtype=torch.bool, device=device),
    )


def edge_residual(T_i, T_j, T_meas):
    """r = log(T_meas^-1 (T_i^-1 T_j))  [..., 6] (v, w)."""
    return se3.se3_log(se3.inverse(T_meas) @ se3.inverse(T_i) @ T_j)


def _edge_residual_jac(T_i, T_j, T_meas):
    """Residual [E, 6] and Jacobians J_i, J_j [E, 6, 6] of a batch of edges
    wrt the right perturbations of their nodes:
    r(d_i, d_j) = log(T_meas^-1 (T_i exp(d_i))^-1 (T_j exp(d_j))).

    Forward-mode autodiff at d = 0, as ``jax.jacfwd``: one pass of dual
    numbers over the 12 basis directions at once ([12, E]), through the same
    ``where`` branches as the value (the small-angle ones near identity)."""
    E = T_i.shape[0]
    basis = torch.eye(12, dtype=T_i.dtype, device=T_i.device)[:, None, :].expand(12, E, 12)
    with fwAD.dual_level():
        d = fwAD.make_dual(torch.zeros_like(basis), basis.contiguous())
        r = edge_residual(T_i @ se3.se3_exp(d[..., :6]), T_j @ se3.se3_exp(d[..., 6:]), T_meas)
        r, J = fwAD.unpack_dual(r)                         # [12, E, 6] each
    J = J.permute(1, 2, 0)                                 # [E, 6, 12]
    return r[0], J[..., :6], J[..., 6:]


class ScatterPlan:
    """A scatter-add with repeated targets as an ordered segment sum.

    ``target`` [K] (values in [0, n)) is stably sorted once; ``sum(values)``
    then adds the K contributions of each target in their order in
    ``target``, with ``torch.segment_reduce``: the same bits on every run and
    on either device.  Built outside the solver loops (it reads nothing back
    to the host)."""

    def __init__(self, target, n: int):
        target = target.long()
        self.order = torch.argsort(target, stable=True)
        bounds = torch.searchsorted(target[self.order],
                                    torch.arange(n + 1, device=target.device))
        self.lengths = bounds[1:] - bounds[:-1]

    def sum(self, values):
        return torch.segment_reduce(values[self.order], "sum", lengths=self.lengths, axis=0,
                                    unsafe=True, initial=0.0)


@dataclasses.dataclass
class GraphPlans:
    """The scatter plans of one graph's edge structure: the gradient and the
    node-diagonal blocks (targets edge_i then edge_j, n nodes) and the dense
    blocks (targets (i, i), (j, j), (i, j), (j, i), n * n blocks)."""

    nodes: ScatterPlan
    blocks: ScatterPlan


def plans_for(edge_i, edge_j, n: int) -> GraphPlans:
    i, j = edge_i.long(), edge_j.long()
    return GraphPlans(
        nodes=ScatterPlan(torch.cat([i, j]), n),
        blocks=ScatterPlan(torch.cat([i * n + i, j * n + j, i * n + j, j * n + i]), n * n),
    )


def edge_blocks_from(poses, edge_i, edge_j, edge_T, edge_info, edge_mask, plans: GraphPlans):
    """THE per-edge block assembly that every solver path builds on.

    Returns (H_ii, H_jj, H_ij [E, 6, 6], g [N, 6], cost) for the edges given;
    the dense Hessian is formed only by ``dense_from_blocks``."""
    T_i = poses[edge_i.long()]
    T_j = poses[edge_j.long()]
    r, J_i, J_j = _edge_residual_jac(T_i, T_j, edge_T)
    w = edge_mask.to(torch.float32)[:, None] * edge_info            # [E, 6]
    r_w = torch.where(edge_mask[:, None], r, 0.0)
    J_i = torch.where(edge_mask[:, None, None], J_i, 0.0)
    J_j = torch.where(edge_mask[:, None, None], J_j, 0.0)
    JiW = J_i * w[:, :, None]          # info-weighted rows: [E, 6 (res), 6 (param)]
    JjW = J_j * w[:, :, None]
    H_ii = torch.einsum("erp,erq->epq", JiW, J_i)
    H_jj = torch.einsum("erp,erq->epq", JjW, J_j)
    H_ij = torch.einsum("erp,erq->epq", JiW, J_j)
    g = plans.nodes.sum(torch.cat([torch.einsum("erp,er->ep", JiW, r_w),
                                   torch.einsum("erp,er->ep", JjW, r_w)]))
    cost = torch.sum(w * r * r)
    return H_ii, H_jj, H_ij, g, cost


def dense_from_blocks(H_ii, H_jj, H_ij, plans: GraphPlans, n: int):
    """Scatter per-edge blocks into the dense [6N, 6N] Hessian (no damping)."""
    H = plans.blocks.sum(torch.cat([H_ii, H_jj, H_ij, H_ij.transpose(-1, -2)]))
    return H.view(n, n, 6, 6).permute(0, 2, 1, 3).reshape(6 * n, 6 * n)


def node_diag_blocks(H_ii, H_jj, plans: GraphPlans):
    """Node-diagonal 6x6 blocks D [N, 6, 6] (the block-Jacobi
    preconditioner base and the source of the LM damping diagonal)."""
    return plans.nodes.sum(torch.cat([H_ii, H_jj]))


def gauge_damping(node_mask, diag_H, lam):
    """Gauge boost + LM damping diagonal [N, 6]: a strong prior on node 0
    and on inactive nodes (solver_g2o.cpp:51-63), plus lam * (diag(H) + 1)."""
    boost = torch.zeros(node_mask.shape[0], dtype=torch.float32, device=node_mask.device)
    boost[0] = 1e6
    boost = torch.where(node_mask, boost, 1e6)
    return boost[:, None] + lam * (diag_H + 1.0)


def _edge_blocks(graph: PoseGraph, plans: GraphPlans):
    """Per-edge 6x6 Hessian blocks and the gradient: the matrix-free system,
    memory O(E + N)."""
    return edge_blocks_from(graph.poses, graph.edge_i, graph.edge_j, graph.edge_T,
                            graph.edge_info, graph.edge_mask, plans)


def _same(t):
    return t


def _assemble(graph: PoseGraph, damping, plans: GraphPlans, reduce=_same):
    """The damped normal equations H dx = -g over all active edges."""
    n = graph.poses.shape[0]
    H_ii, H_jj, H_ij, g2, _ = _edge_blocks(graph, plans)
    H = reduce(dense_from_blocks(H_ii, H_jj, H_ij, plans, n))
    g2 = reduce(g2)
    damp = gauge_damping(graph.node_mask, torch.diagonal(H).reshape(n, 6), damping)
    H.diagonal().add_(damp.reshape(6 * n))
    return H, g2.reshape(6 * n)


def _hvp(H_ii, H_jj, H_ij, plans: GraphPlans, edge_i, edge_j, damp_diag, v, reduce=_same):
    """Damped Hessian-vector product by edge scatter: v, out [N, 6]."""
    vi = v[edge_i.long()]
    vj = v[edge_j.long()]
    out = plans.nodes.sum(torch.cat([
        torch.einsum("epq,eq->ep", H_ii, vi) + torch.einsum("epq,eq->ep", H_ij, vj),
        torch.einsum("eqp,eq->ep", H_ij, vi) + torch.einsum("epq,eq->ep", H_jj, vj),
    ]))
    return reduce(out) + damp_diag * v


def _damping_terms(graph: PoseGraph, H_ii, H_jj, lam, plans: GraphPlans, reduce=_same):
    """Gauge boost + LM damping as a diagonal [N, 6], and the block-Jacobi
    preconditioner blocks [N, 6, 6] (node-diagonal blocks + damping)."""
    D = reduce(node_diag_blocks(H_ii, H_jj, plans))
    damp = gauge_damping(graph.node_mask, torch.diagonal(D, dim1=-2, dim2=-1), lam)
    return damp, D + torch.diag_embed(damp)


def _pcg_solve(H_ii, H_jj, H_ij, plans: GraphPlans, edge_i, edge_j, damp, M, g, iters: int,
               reduce=_same):
    """Block-Jacobi preconditioned CG for H dx = -g, ``iters`` iterations
    with a masked freeze once the residual is tiny (no host read)."""
    Minv = torch.linalg.inv_ex(M).inverse                        # [N, 6, 6]
    apply_M = lambda r: torch.einsum("npq,nq->np", Minv, r)
    hv = lambda p: _hvp(H_ii, H_jj, H_ij, plans, edge_i, edge_j, damp, p, reduce)
    eps = torch.tensor(1e-20, dtype=torch.float32, device=g.device)

    x = torch.zeros_like(g)
    r = -g                                         # b = -g, x0 = 0
    z = apply_M(r)
    p = z
    rz = torch.sum(r * z)
    for _ in range(iters):
        Hp = hv(p)
        denom = torch.sum(p * Hp)
        alpha = rz / torch.maximum(denom, eps)
        live = torch.sum(r * r) > 1e-12
        alpha = torch.where(live & (denom > 0), alpha, 0.0)
        x = x + alpha * p
        r_new = r - alpha * Hp
        z_new = apply_M(r_new)
        rz_new = torch.sum(r_new * z_new)
        beta = torch.where(live, rz_new / torch.maximum(rz, eps), 0.0)
        p = z_new + beta * p
        r, rz = r_new, rz_new
    return x


def _cost(graph: PoseGraph):
    r = edge_residual(graph.poses[graph.edge_i.long()], graph.poses[graph.edge_j.long()],
                      graph.edge_T)
    w = graph.edge_mask.to(torch.float32)[:, None] * graph.edge_info
    return torch.sum(w * r * r)


def _apply_update(graph: PoseGraph, dx):
    n = graph.poses.shape[0]
    d = torch.where(graph.node_mask[:, None], dx.reshape(n, 6), 0.0)
    d[0] = 0.0
    return dataclasses.replace(graph, poses=graph.poses @ se3.se3_exp(d))


def gn_nan_guard(x):
    return torch.where(torch.isfinite(x), x, 0.0)


def _solve_dense(graph: PoseGraph, lam, plans: GraphPlans, reduce=_same):
    """The damped system factored by Cholesky.  ``cholesky_ex`` reports a
    failed factorization in ``info`` on the device; its factor is then not
    NaN but garbage, so the step is zeroed there explicitly."""
    H, g = _assemble(graph, lam, plans, reduce)
    L, info = torch.linalg.cholesky_ex(H)
    y = torch.linalg.solve_triangular(L, -g[:, None], upper=False)
    dx = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)[:, 0]
    return torch.where(info == 0, dx, 0.0)


def _solve_cg(graph: PoseGraph, lam, plans: GraphPlans, iters: int, reduce=_same):
    n = graph.poses.shape[0]
    H_ii, H_jj, H_ij, g, _ = _edge_blocks(graph, plans)
    damp, M = _damping_terms(graph, H_ii, H_jj, lam, plans, reduce)
    dx = _pcg_solve(H_ii, H_jj, H_ij, plans, graph.edge_i, graph.edge_j, damp, M, reduce(g),
                    iters, reduce)
    return dx.reshape(6 * n)


def optimize(graph: PoseGraph, cfg: PoseGraphConfig = PoseGraphConfig()):
    """LM loop with multiplicative damping adaptation (lm_var equivalent).

    Returns (graph', diagnostics dict of 0-d tensors: ``initial_cost``,
    ``final_cost``, ``lambda``).  ``max_iterations`` LM iterations run, each
    a candidate step accepted where it lowers the cost, all as tensor ops on
    the graph's device with no host read."""
    return lm_loop(graph, cfg)


def lm_loop(graph: PoseGraph, cfg: PoseGraphConfig, reduce=_same):
    """``optimize`` over the edges of ``graph``, with ``reduce`` summing
    each assembled quantity and cost over the ranks that hold the other
    edges (``parallel/batch.sharded_pose_graph_optimize``)."""
    if cfg.solver not in ("cg", "dense"):
        raise ValueError(f"unknown pose-graph solver {cfg.solver!r}")
    n = graph.poses.shape[0]
    plans = plans_for(graph.edge_i, graph.edge_j, n)
    if cfg.solver == "cg":
        inner_solve = lambda gr, lam: _solve_cg(gr, lam, plans, cfg.pcg_iters, reduce)
    else:
        inner_solve = lambda gr, lam: _solve_dense(gr, lam, plans, reduce)

    dev = graph.poses.device
    lam = torch.tensor(cfg.lm_init_lambda, dtype=torch.float32, device=dev)
    factor = torch.tensor(cfg.lm_lambda_factor, dtype=torch.float32, device=dev)
    cost0 = reduce(_cost(graph))
    cost = cost0
    for _ in range(cfg.max_iterations):
        dx = gn_nan_guard(inner_solve(graph, lam))
        cand = _apply_update(graph, dx)
        new_cost = reduce(_cost(cand))
        accept = new_cost < cost
        graph = dataclasses.replace(graph, poses=torch.where(accept, cand.poses, graph.poses))
        lam = torch.where(accept, lam / factor, lam * factor)
        lam = torch.clamp(lam, 1e-9, 1e6)
        cost = torch.where(accept, new_cost, cost)
    return graph, {"initial_cost": cost0, "final_cost": cost, "lambda": lam}


# ---------------------------------------------------------------------------
# host-side graph construction (used by models/graph.py)
# ---------------------------------------------------------------------------


def from_arrays(poses, edge_i, edge_j, edge_T, edge_info, max_nodes: int | None = None,
                max_edges: int | None = None, device="cuda") -> PoseGraph:
    """A PoseGraph from dense host arrays in one transfer per field: the
    padding and masks are made in numpy."""
    poses = np.asarray(poses, np.float32)
    edge_i = np.asarray(edge_i, np.int32)
    edge_j = np.asarray(edge_j, np.int32)
    edge_T = np.asarray(edge_T, np.float32)
    edge_info = np.asarray(edge_info, np.float32)
    n, e = poses.shape[0], edge_i.shape[0]
    N = max_nodes or n
    E = max_edges or e

    def pad(a, cap, fill):
        out = np.empty((cap,) + a.shape[1:], a.dtype)
        out[:a.shape[0]] = a
        out[a.shape[0]:] = fill
        return torch.from_numpy(out).to(device)

    eye = np.eye(4, dtype=np.float32)
    return PoseGraph(
        poses=pad(poses, N, eye),
        node_mask=torch.from_numpy(np.arange(N) < n).to(device),
        edge_i=pad(edge_i, E, 0),
        edge_j=pad(edge_j, E, 0),
        edge_T=pad(edge_T, E, eye),
        edge_info=pad(edge_info, E, 1.0),
        edge_mask=torch.from_numpy(np.arange(E) < e).to(device),
    )


def _set(t, idx, value):
    out = t.clone()
    out[idx] = torch.as_tensor(value, dtype=t.dtype, device=t.device)
    return out


def add_node(graph: PoseGraph, idx: int, pose) -> PoseGraph:
    return dataclasses.replace(graph, poses=_set(graph.poses, idx, pose),
                               node_mask=_set(graph.node_mask, idx, True))


def add_edge(graph: PoseGraph, slot: int, i, j, T_rel, info_diag) -> PoseGraph:
    return dataclasses.replace(
        graph,
        edge_i=_set(graph.edge_i, slot, i),
        edge_j=_set(graph.edge_j, slot, j),
        edge_T=_set(graph.edge_T, slot, T_rel),
        edge_info=_set(graph.edge_info, slot, info_diag),
        edge_mask=_set(graph.edge_mask, slot, True),
    )
