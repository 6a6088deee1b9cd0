"""Bundle adjustment with landmark Schur complement (counterpart of
``orb_slam3_rgbl_tpu.optim.local_ba``; reference
``Optimizer::LocalBundleAdjustment`` and ``BundleAdjustment``).

BA's sparsity is structured (arrow-head): the landmark blocks are
eliminated with batched 3×3 inverses and the reduced camera system is
small and dense.

Layout (fixed capacity, masked):

* poses:      (K, 7) SE3 world→camera; ``pose_fixed`` (K,) bool, the
  gauge/observer keyframes (the reference's ``vpFixedCameras``).
* landmarks:  (M, 3); ``lm_valid`` (M,) bool.
* observations grouped by landmark: (M, D), each landmark seen by at most
  D keyframes (``obs_kf`` index, uv / u_right / inv_sigma2 / mask).

Pose blocks are reduced from the per-observation 6×6 blocks with one
``(K, M·D) @ (M·D, 42)`` product against the observations' one-hot
keyframe matrix: a sum in a fixed order, so two runs give the same bits
(``index_add_`` on the card adds in an unspecified order, and a last-bit
difference can flip the accept test). The Schur complement
S = U − G V⁻¹ Gᵀ is assembled as C = G·chol(V⁻¹) and S_cross = C₂ C₂ᵀ, one
``(6K, 3M)`` product. Solves use the ``_ex`` forms and the accept decision
is a ``torch.where`` on device tensors: nothing in the solve waits for the
card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from orb_slam3_rgbl_tpu_torch.geometry import lie
from orb_slam3_rgbl_tpu_torch.geometry.camera import (
    PinholeCamera, geo_project, geo_project_jacobian, is_fisheye,
)
from orb_slam3_rgbl_tpu_torch.optim.pose_opt import (
    CHI2_MONO, CHI2_STEREO, HUBER_MONO, HUBER_STEREO,
)


class BAProblem(NamedTuple):
    """A fixed-shape bundle adjustment problem instance."""

    poses: torch.Tensor       # (K, 7) Tcw
    pose_fixed: torch.Tensor  # (K,) bool — not optimized (still constrain points)
    pose_valid: torch.Tensor  # (K,) bool
    landmarks: torch.Tensor   # (M, 3)
    lm_valid: torch.Tensor    # (M,) bool
    obs_kf: torch.Tensor      # (M, D) int64 keyframe index of each observation
    obs_uv: torch.Tensor      # (M, D, 2)
    obs_ur: torch.Tensor      # (M, D) pseudo-stereo column or −1 (mono)
    obs_inv_sigma2: torch.Tensor  # (M, D)
    obs_mask: torch.Tensor    # (M, D) bool


class BAResult(NamedTuple):
    poses: torch.Tensor
    landmarks: torch.Tensor
    obs_inlier: torch.Tensor  # (M, D) final chi2 classification
    cost: torch.Tensor


def _linearize(problem: BAProblem, cam, use_huber: bool, obs_active: torch.Tensor):
    """Residuals and Jacobians of all (M, D) observations.

    Returns r (M, D, 3), Jp (M, D, 3, 6), Jl (M, D, 3, 3), weights w
    (M, D), chi2 (M, D), the per-observation active mask and the robust
    cost. ``cam`` is any camera model; fisheye observations carry no
    pseudo-stereo row."""
    P = problem
    T_obs = P.poses[P.obs_kf]                                   # (M, D, 7)
    pc = lie.se3_apply(T_obs, P.landmarks[:, None, :])          # (M, D, 3)
    z = pc[..., 2]
    safe_z = torch.where(z.abs() < 1e-6, 1e-6, z)
    inv_z = 1.0 / safe_z
    uv_hat = geo_project(cam, pc)
    u_hat, v_hat = uv_hat[..., 0], uv_hat[..., 1]

    is_stereo = P.obs_ur >= 0
    if is_fisheye(cam):
        is_stereo = torch.zeros_like(is_stereo)
    ur_hat = u_hat - cam.bf * inv_z
    r = torch.stack([P.obs_uv[..., 0] - u_hat, P.obs_uv[..., 1] - v_hat,
                     torch.where(is_stereo, P.obs_ur - ur_hat, 0.0)], dim=-1)

    zeros = torch.zeros_like(z)
    Juv = geo_project_jacobian(cam, pc)                         # (M, D, 2, 3)
    row_u = Juv[..., 0, :]
    row_r = row_u + torch.stack([zeros, zeros, cam.bf * inv_z * inv_z], dim=-1)
    Jproj = torch.stack([row_u, Juv[..., 1, :], row_r], dim=-2)  # d(u,v,uR)/d(pc)

    R_obs = lie.quat_to_matrix(T_obs[..., :4])                  # (M, D, 3, 3)
    # pose: left-multiplicative tangent — d(pc)/dδ = [I | −[pc]×]
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[:-1] + (3, 3))
    dpc_dpose = torch.cat([eye, -lie.so3_hat(pc)], dim=-1)      # (M, D, 3, 6)
    # a mono observation has no uR row
    ones = torch.ones_like(z)
    row_on = torch.stack([ones, ones, is_stereo.to(pc.dtype)], dim=-1)[..., None]
    Jp = -(Jproj @ dpc_dpose) * row_on
    Jl = -(Jproj @ R_obs) * row_on                              # d(pc)/dX = R

    depth_ok = z > 1e-3
    considered = obs_active & P.obs_mask & P.lm_valid[:, None] & P.pose_valid[P.obs_kf]
    active = considered & depth_ok
    chi2 = torch.sum(r * r, dim=-1) * P.obs_inv_sigma2
    if use_huber:
        delta = torch.where(is_stereo, HUBER_STEREO, HUBER_MONO)
        e = torch.sqrt(chi2.clamp_min(1e-12))
        w_rob = torch.where(e > delta, delta / e, 1.0)
    else:
        w_rob = torch.ones_like(chi2)
    w = torch.where(active, P.obs_inv_sigma2 * w_rob, 0.0)
    # an observation thrown behind the camera costs the chi² cap instead of
    # vanishing: otherwise a weakly-constrained pose can "improve" the cost
    # by flying away and de-activating its own residuals
    cost = (torch.sum(torch.where(active, chi2.clamp_max(1e7) * w_rob, 0.0))
            + 1e7 * torch.sum(considered & ~depth_ok))
    return r, Jp, Jl, w, chi2, active, cost


def _diag_part(A: torch.Tensor) -> torch.Tensor:
    """The diagonal of each matrix of a batch, as diagonal matrices."""
    return torch.diag_embed(torch.diagonal(A, dim1=-2, dim2=-1))


def _reduced_system(problem: BAProblem, r, Jp, Jl, w, lam, n_poses: int):
    """The damped reduced camera system of one linearization, before the
    fixed and invalid poses are masked: (S (6K, 6K), rhs (6K,)) and what the
    back-substitution needs (V⁻¹, b_l, W). A sum over observations: the
    landmark-sharded solve (``parallel/sharded_ba``) adds S and rhs over its
    ranks."""
    P = problem
    K = n_poses
    M, D = P.obs_kf.shape
    dtype, dev = r.dtype, r.device
    eye3 = torch.eye(3, dtype=dtype, device=dev)

    wJp = w[..., None, None] * Jp                                # (M, D, 3, 6)
    wJl = w[..., None, None] * Jl                                # (M, D, 3, 3)
    # pose blocks: per-observation JᵀWJ (6×6) and JᵀWr (6), reduced onto
    # the K poses by one product with the one-hot keyframe matrix
    onehot = torch.nn.functional.one_hot(P.obs_kf, K).to(dtype)  # (M, D, K)
    per_obs = torch.cat([(wJp.transpose(-1, -2) @ Jp).reshape(M * D, 36),
                         (wJp.transpose(-1, -2) @ r[..., None]).reshape(M * D, 6)], dim=1)
    pose_sums = onehot.reshape(M * D, K).T @ per_obs             # (K, 42)
    U = pose_sums[:, :36].reshape(K, 6, 6)
    b_p = pose_sums[:, 36:]

    V = torch.sum(Jl.transpose(-1, -2) @ wJl, dim=1)             # (M, 3, 3)
    b_l = torch.sum(wJl.transpose(-1, -2) @ r[..., None], dim=1)[..., 0]   # (M, 3)
    Wpl = Jp.transpose(-1, -2) @ wJl                             # (M, D, 6, 3)

    # damp V and invert per landmark (identity for empty landmarks)
    V_d = V + (lam * _diag_part(V) + 1e-8 * eye3)
    has_lm = P.lm_valid
    V_d = torch.where(has_lm[:, None, None], V_d, eye3)
    Vinv = torch.linalg.inv_ex(V_d)[0]

    # per-landmark pose coupling G_m = Σ_d onehot ⊗ Wpl → (M, K, 6, 3)
    G = (onehot.transpose(1, 2) @ Wpl.reshape(M, D, 18)).reshape(M, K, 6, 3)
    # C = G · chol(V⁻¹): Schur cross term = Σ_m C Cᵀ, one product
    L = torch.linalg.cholesky_ex(Vinv + 1e-12 * eye3)[0]
    C = G.reshape(M, K * 6, 3) @ L                               # (M, 6K, 3)
    C2 = C.transpose(0, 1).reshape(K * 6, M * 3)
    S_cross = C2 @ C2.T                                          # (6K, 6K)

    # reduced right-hand side
    Vinv_bl = (Vinv @ b_l[..., None])[..., 0]
    b_cross = torch.einsum("mkjl,ml->kj", G, Vinv_bl)

    U_damped = U + lam * _diag_part(U)
    S_full = torch.block_diag(*U_damped.unbind(0)) - S_cross
    rhs = (b_p - b_cross).reshape(K * 6)
    return S_full, rhs, Vinv, b_l, Wpl


def _solve_reduced(problem: BAProblem, S_full, rhs) -> torch.Tensor:
    """δposes (K, 6) of the reduced system, the fixed and invalid poses held."""
    free6 = ((~problem.pose_fixed) & problem.pose_valid).repeat_interleave(6)
    # fixed / invalid poses: identity rows and columns, zero right-hand side
    S_full = torch.where(free6[:, None] & free6[None, :], S_full, 0.0)
    S_full = S_full + torch.diag(torch.where(free6, 1e-9, 1.0).to(S_full.dtype))
    rhs = torch.where(free6, rhs, 0.0)
    # solve_ex skips the error check, which would wait for the card
    return -torch.linalg.solve_ex(S_full, rhs[:, None])[0][:, 0].reshape(-1, 6)


def _back_substitute(problem: BAProblem, delta_p, Vinv, b_l, Wpl) -> torch.Tensor:
    """δl = −V⁻¹ (b_l + Σ_d Wᵀ δp)  (sign: H δ = −b); 0 for invalid landmarks."""
    dp_obs = delta_p[problem.obs_kf]                             # (M, D, 6)
    Wt_dp = torch.sum(Wpl.transpose(-1, -2) @ dp_obs[..., None], dim=1)[..., 0]
    delta_l = -(Vinv @ (b_l + Wt_dp)[..., None])[..., 0]
    return torch.where(problem.lm_valid[:, None], delta_l, 0.0)


def _build_and_solve(problem: BAProblem, cam, r, Jp, Jl, w, lam, n_poses: int):
    """One damped Schur step: returns (delta_poses (K, 6), delta_lms (M, 3))."""
    S_full, rhs, Vinv, b_l, Wpl = _reduced_system(problem, r, Jp, Jl, w, lam, n_poses)
    delta_p = _solve_reduced(problem, S_full, rhs)
    return delta_p, _back_substitute(problem, delta_p, Vinv, b_l, Wpl)


def bundle_adjust(problem: BAProblem, cam: PinholeCamera, iterations: int = 10,
                  huber_iters: int = 7, n_iters: Optional[int] = None) -> BAResult:
    """Damped Gauss-Newton (LM) with landmark Schur elimination.

    Mirrors the reference local BA protocol (``Optimizer.cc:1116-1500``):
    ~10 abortable iterations with Huber, then outlier classification at
    chi2 thresholds. Accept/reject per iteration keeps the solve monotone
    (branchless: both candidates are evaluated).

    ``n_iters``: optional iteration count ≤ ``iterations``, the
    abortable-BA analog (reference ``mbAbortBA``): the mapping plane
    throttles the budget at run time. The loop runs on the host and every
    decision inside it stays on the device; the caller downloads once."""
    K = problem.poses.shape[0]
    dtype, dev = problem.poses.dtype, problem.poses.device
    chi2_th = torch.where(problem.obs_ur >= 0, CHI2_STEREO, CHI2_MONO)
    n = iterations if n_iters is None else min(int(n_iters), iterations)

    poses, lms = problem.poses, problem.landmarks
    lam = torch.full((), 1e-4, dtype=dtype, device=dev)
    obs_active = problem.obs_mask
    cost = torch.full((), float("inf"), dtype=dtype, device=dev)
    for it in range(n):
        P = problem._replace(poses=poses, landmarks=lms)
        use_huber = it < huber_iters
        r, Jp, Jl, w, chi2, active, cost_old = _linearize(P, cam, use_huber, obs_active)
        dp, dl = _build_and_solve(P, cam, r, Jp, Jl, w, lam, K)
        new_poses = lie.se3_normalize(lie.se3_mul(lie.se3_exp(dp), poses))
        new_lms = lms + dl
        P2 = P._replace(poses=new_poses, landmarks=new_lms)
        _, _, _, _, chi2_new, active2, cost_new = _linearize(P2, cam, use_huber, obs_active)
        # a diverged step can throw every point behind the camera (or go
        # NaN): the active set empties, the cost collapses to 0 and would
        # "win" — accept only finite steps that keep the active set alive
        accept = ((cost_new < cost_old) & torch.isfinite(cost_new)
                  & (2 * active2.sum() >= active.sum()))
        poses = torch.where(accept, new_poses, poses)
        lms = torch.where(accept, new_lms, lms)
        lam = torch.where(accept, (lam * 0.5).clamp_min(1e-10), (lam * 4.0).clamp_max(1e4))
        cost = torch.where(accept, cost_new, cost_old)
        # mid-solve outlier culling (reference Optimizer.cc:1404-1421: drop
        # chi2 > th after the robust phase, continue without them). chi2 is
        # Huber-independent, so the accepted state's chi2 is already in hand
        if it == huber_iters - 1:
            chi2_now = torch.where(accept, chi2_new, chi2)
            obs_active = obs_active & (chi2_now <= 2.0 * chi2_th)

    # final classification (reference: chi2 > 5.991/7.815 or negative depth → erase)
    P = problem._replace(poses=poses, landmarks=lms)
    _, _, _, _, chi2, active, _ = _linearize(P, cam, False, torch.ones_like(problem.obs_mask))
    inlier = active & (chi2 <= chi2_th)
    return BAResult(poses=poses, landmarks=lms, obs_inlier=inlier, cost=cost)
