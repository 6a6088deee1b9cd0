"""Sim3/SE3 pose-graph (essential graph) optimization (counterpart of
``orb_slam3_rgbl_tpu.optim.pose_graph``; reference
``Optimizer::OptimizeEssentialGraph``).

Nodes are keyframe Sim3 poses S_iw, edges are relative constraints S_ij
(spanning chain, loop edges, strong covisibility edges). Edge residuals
r_e = log(S_ij · S_jw · S_iw⁻¹) with Jacobians from forward-mode autodiff
at the identity perturbation, batched over the edges; the normal equations
are a dense (7K, 7K) system, assembled by products with the edges' one-hot
node matrices (a sum in a fixed order) and solved with damping and an
accept test that stay on the device. The problem holds the real K nodes
and E edges. The 4-DoF variant for inertial maps belongs to ROADMAP Queue 1
item 15.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_rgbl_tpu_torch.geometry import lie


class PoseGraphProblem(NamedTuple):
    nodes: torch.Tensor        # (K, 8) Sim3 S_iw (world→kf)
    node_fixed: torch.Tensor   # (K,) bool — e.g. the loop keyframe
    node_valid: torch.Tensor   # (K,) bool
    edge_i: torch.Tensor       # (E,) int64
    edge_j: torch.Tensor       # (E,) int64
    edge_Sij: torch.Tensor     # (E, 8) measured S_i←j = S_iw · S_jw⁻¹
    edge_weight: torch.Tensor  # (E,) f32 (information scale)
    edge_valid: torch.Tensor   # (E,) bool


def _edge_residual(Si, Sj, Sij, tau_i, tau_j) -> torch.Tensor:
    """r = log( S_ij · (exp(τ_j)·S_jw) · (exp(τ_i)·S_iw)⁻¹ ) — (7,)."""
    Si_p = lie.sim3_mul(lie.sim3_exp(tau_i), Si)
    Sj_p = lie.sim3_mul(lie.sim3_exp(tau_j), Sj)
    return lie.sim3_log(lie.sim3_mul(Sij, lie.sim3_mul(Sj_p, lie.sim3_inv(Si_p))))


def linearize_edges(problem: PoseGraphProblem, nodes: torch.Tensor):
    """Residuals (E, 7) and both endpoint Jacobians (E, 7, 7) of every edge
    at ``nodes``: one forward-mode pass over the 14 tangent directions."""
    zero14 = torch.zeros(14, dtype=nodes.dtype, device=nodes.device)

    def one_edge(Si, Sj, Sij):
        def res(t):
            r = _edge_residual(Si, Sj, Sij, t[:7], t[7:])
            return r, r
        return torch.func.jacfwd(res, has_aux=True)(zero14)

    J, r = torch.func.vmap(one_edge)(nodes[problem.edge_i], nodes[problem.edge_j],
                                     problem.edge_Sij)
    return r, J[..., :7], J[..., 7:]


def optimize_pose_graph(problem: PoseGraphProblem, iterations: int = 20,
                        fix_scale: bool = False) -> torch.Tensor:
    """Damped Gauss-Newton over all nodes; returns the updated (K, 8) Sim3
    nodes. ``fix_scale`` freezes every node's scale (the depth-sensor case,
    where scale does not drift). Nothing in it waits for the device."""
    K = problem.nodes.shape[0]
    E = problem.edge_i.shape[0]
    dtype, dev = problem.nodes.dtype, problem.nodes.device

    free = (~problem.node_fixed) & problem.node_valid
    free7 = free.repeat_interleave(7)
    if fix_scale:
        # made on the device: a tensor from a Python list is a copy that waits
        free7 = free7 & (torch.arange(7 * K, device=dev) % 7 != 6)
    free77 = free7[:, None] & free7[None, :]
    floor_diag = torch.diag(torch.where(free7, 1e-6, 1.0).to(dtype))
    w = torch.where(problem.edge_valid, problem.edge_weight.to(dtype), 0.0)
    oh_i = torch.nn.functional.one_hot(problem.edge_i, K).to(dtype)    # (E, K)
    oh_j = torch.nn.functional.one_hot(problem.edge_j, K).to(dtype)

    def blocks(oh_a, Ja, oh_b, Jb):
        """Σ_e onehot_a ⊗ onehot_b ⊗ (Jaᵀ w Jb) as (K, 7, K, 7)."""
        per_edge = (Ja.transpose(-1, -2) @ (w[:, None, None] * Jb)).reshape(E, 1, 49)
        out = oh_a.T @ (oh_b[:, :, None] * per_edge).reshape(E, K * 49)   # (K, K·49)
        return out.reshape(K, K, 7, 7).permute(0, 2, 1, 3)

    def rhs(oh_a, Ja, r):
        return oh_a.T @ (Ja.transpose(-1, -2) @ (w[:, None] * r)[..., None])[..., 0]   # (K, 7)

    nodes = problem.nodes
    lam = torch.full((), 1e-4, dtype=dtype, device=dev)
    for _ in range(iterations):
        # damped accept/reject: plain Gauss-Newton in f32 can diverge on an
        # ill-conditioned essential graph
        r, Ji, Jj = linearize_edges(problem, nodes)
        cost0 = torch.sum(w * torch.sum(r * r, dim=-1))
        H = (blocks(oh_i, Ji, oh_i, Ji) + blocks(oh_i, Ji, oh_j, Jj)
             + blocks(oh_j, Jj, oh_i, Ji) + blocks(oh_j, Jj, oh_j, Jj)).reshape(7 * K, 7 * K)
        b = (rhs(oh_i, Ji, r) + rhs(oh_j, Jj, r)).reshape(7 * K)
        H = torch.where(free77, H, 0.0)
        H = H + lam * torch.diag(torch.diagonal(H)) + floor_diag
        b = torch.where(free7, b, 0.0)
        tau = -torch.linalg.solve_ex(H, b[:, None])[0][:, 0].reshape(K, 7)
        tau = torch.where(free[:, None], tau, 0.0)
        if fix_scale:
            tau = torch.cat([tau[:, :6], torch.zeros_like(tau[:, :1])], dim=1)
        new_nodes = lie.sim3_mul(lie.sim3_exp(tau), nodes)
        cost1 = pose_graph_cost(problem, new_nodes)
        ok = torch.isfinite(cost1) & (cost1 < cost0)
        nodes = torch.where(ok, new_nodes, nodes)
        lam = torch.where(ok, (lam * 0.5).clamp_min(1e-8), (lam * 4.0).clamp_max(1e4))
    return nodes


def pose_graph_cost(problem: PoseGraphProblem, nodes: torch.Tensor) -> torch.Tensor:
    """Weighted squared edge residual of ``nodes``: the quantity
    ``optimize_pose_graph`` lowers."""
    zero7 = torch.zeros(7, dtype=nodes.dtype, device=nodes.device)
    r = torch.func.vmap(_edge_residual, in_dims=(0, 0, 0, None, None))(
        nodes[problem.edge_i], nodes[problem.edge_j], problem.edge_Sij, zero7, zero7)
    w = torch.where(problem.edge_valid, problem.edge_weight.to(nodes.dtype), 0.0)
    return torch.sum(w * torch.sum(r * r, dim=-1))


def relative_sim3(nodes: torch.Tensor, i, j) -> torch.Tensor:
    """S_i←j = S_iw · S_jw⁻¹ for edge construction."""
    return lie.sim3_mul(nodes[i], lie.sim3_inv(nodes[j]))
