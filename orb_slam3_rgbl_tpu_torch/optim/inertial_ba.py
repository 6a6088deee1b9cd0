"""Sliding-window visual-inertial bundle adjustment (counterpart of
``orb_slam3_rgbl_tpu.optim.inertial_ba``; reference
``Optimizer::LocalInertialBA`` and ``FullInertialBA``).

States are BODY poses Twb with velocity and both biases, 15 tangent
dimensions [pose(6), vel(3), bg(3), ba(3)]; the camera sees through the
fixed extrinsic T_cb. Gravity is the world −z axis (maps are re-expressed
gravity-down by IMU initialization). Factors: reprojection (Huber, then an
outlier cull), the preintegration factor and the bias random walks of each
consecutive pair. Landmarks are Schur-eliminated as in ``optim.local_ba``
(batched 3×3 inverses, C = G·chol(V⁻¹), one (15K, 3M) product), the visual
Jacobian in columns 0:6 of the 15-wide pose blocks; each pair's inertial
Jacobian (15 × 30) comes from forward-mode autodiff (``torch.func.jacfwd``),
as in the JAX package.
The reduced system is (15K)² dense. Every block sum is a product with a
one-hot matrix (observation → keyframe, pair → endpoint): a sum in a fixed
order, so two runs give the same bits and the accept test cannot flip on
the card's unordered atomics. The problem holds the real K states, M
landmarks and P pairs; the loop runs on the host and every decision inside
it stays on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_rgbl_tpu_torch.geometry import lie
from orb_slam3_rgbl_tpu_torch.geometry.camera import (PinholeCamera, geo_project,
                                                      geo_project_jacobian, is_fisheye)
from orb_slam3_rgbl_tpu_torch.imu import preintegration as pre
from orb_slam3_rgbl_tpu_torch.optim.pose_opt import (CHI2_MONO, CHI2_STEREO, HUBER_MONO,
                                                     HUBER_STEREO)

S = 15  # state tangent dimension


class VIBAProblem(NamedTuple):
    Twb: torch.Tensor          # (K, 7) body → world poses
    vel: torch.Tensor          # (K, 3) world velocities
    bg: torch.Tensor           # (K, 3) gyro biases
    ba: torch.Tensor           # (K, 3) accel biases
    state_fixed: torch.Tensor  # (K,) bool — anchors (pose, velocity and biases frozen)
    state_valid: torch.Tensor  # (K,) bool
    T_cb: torch.Tensor         # (7,) body → camera extrinsic
    landmarks: torch.Tensor    # (M, 3)
    lm_valid: torch.Tensor     # (M,)
    obs_kf: torch.Tensor       # (M, D) int64 state slot of each observation
    obs_uv: torch.Tensor       # (M, D, 2)
    obs_ur: torch.Tensor       # (M, D)
    obs_inv_sigma2: torch.Tensor  # (M, D)
    obs_mask: torch.Tensor     # (M, D)
    pair_i: torch.Tensor       # (P,) int64 first slot of each temporal IMU factor
    pair_j: torch.Tensor       # (P,) int64 second slot
    pair_meas: pre.Preintegrated  # stacked (P, ...) preintegrations i → j
    pair_valid: torch.Tensor   # (P,)
    info_bg: torch.Tensor      # (P,) gyro-walk information
    info_ba: torch.Tensor      # (P,) accel-walk information


class VIBAResult(NamedTuple):
    Twb: torch.Tensor
    vel: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor
    landmarks: torch.Tensor
    obs_inlier: torch.Tensor
    cost: torch.Tensor


def _apply_state_delta(P: VIBAProblem, dx: torch.Tensor) -> VIBAProblem:
    """dx (K, 15) → updated states (left-multiplied pose tangent)."""
    Twb = lie.se3_normalize(lie.se3_mul(lie.se3_exp(dx[:, 0:6]), P.Twb))
    return P._replace(Twb=Twb, vel=P.vel + dx[:, 6:9], bg=P.bg + dx[:, 9:12],
                      ba=P.ba + dx[:, 12:15])


def _visual_linearize(P: VIBAProblem, cam, use_huber: bool, obs_active: torch.Tensor):
    """Reprojection residuals through Tcw = T_cb · Twb⁻¹. Perturbation
    Twb ← exp(δ)·Twb, so d(pc)/dδ = −R_cw·[I | −[X]×] with X the world point."""
    T_cw = lie.se3_mul(P.T_cb[None, :], lie.se3_inv(P.Twb))      # (K, 7)
    T_obs = T_cw[P.obs_kf]                                       # (M, D, 7)
    X = P.landmarks[:, None, :].expand(P.obs_kf.shape + (3,))
    pc = lie.se3_apply(T_obs, X)
    z = pc[..., 2]
    inv_z = 1.0 / torch.where(z.abs() < 1e-6, 1e-6, z)
    uv_hat = geo_project(cam, pc)
    u_hat, v_hat = uv_hat[..., 0], uv_hat[..., 1]
    is_stereo = P.obs_ur >= 0
    if is_fisheye(cam):                  # fisheye observations are always mono
        is_stereo = torch.zeros_like(is_stereo)
    ur_hat = u_hat - cam.bf * inv_z
    r = torch.stack([P.obs_uv[..., 0] - u_hat, P.obs_uv[..., 1] - v_hat,
                     torch.where(is_stereo, P.obs_ur - ur_hat, 0.0)], dim=-1)

    zeros = torch.zeros_like(z)
    Juv = geo_project_jacobian(cam, pc)
    row_u = Juv[..., 0, :]
    row_r = row_u + torch.stack([zeros, zeros, cam.bf * inv_z * inv_z], dim=-1)
    Jproj = torch.stack([row_u, Juv[..., 1, :], row_r], dim=-2)  # (M, D, 3, 3)

    R_cw = lie.quat_to_matrix(lie.se3_rot(T_obs))                # (M, D, 3, 3)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[:-1] + (3, 3))
    dXb = torch.cat([eye, -lie.so3_hat(X)], dim=-1)              # (M, D, 3, 6)
    # r = obs − proj ⇒ J = +Jproj·R_cw·dXb for the pose, −Jproj·R_cw for the point
    JR = Jproj @ R_cw
    sel = torch.stack([torch.ones_like(z), torch.ones_like(z), is_stereo.to(pc.dtype)],
                      dim=-1)[..., None]
    Jpose = (JR @ dXb) * sel
    Jl = -JR * sel

    active = (obs_active & P.obs_mask & (z > 1e-3) & P.lm_valid[:, None]
              & P.state_valid[P.obs_kf])
    chi2 = torch.sum(r * r, dim=-1) * P.obs_inv_sigma2
    if use_huber:
        delta = torch.where(is_stereo, HUBER_STEREO, HUBER_MONO)
        e = torch.sqrt(chi2.clamp_min(1e-12))
        w_rob = torch.where(e > delta, delta / e, 1.0)
    else:
        w_rob = torch.ones_like(chi2)
    w = torch.where(active, P.obs_inv_sigma2 * w_rob, 0.0)
    cost = torch.sum(torch.where(active, chi2.clamp_max(1e7) * w_rob, 0.0))
    return r, Jpose, Jl, w, chi2, active, cost


def _pair_residual(d: torch.Tensor, T1, T2, v1, v2, bg1, ba1, bg2, ba2, m: pre.Preintegrated,
                   g: torch.Tensor):
    """[preintegration (9), bias walk (6)] of one pair at the tangent
    ``d`` (30,) of both states. Returns (r, r): the residual and, as the
    Jacobian pass's aux, its value."""
    d1, d2 = d[:S], d[S:]
    T1p = lie.se3_mul(lie.se3_exp(d1[0:6]), T1)
    T2p = lie.se3_mul(lie.se3_exp(d2[0:6]), T2)
    b1 = pre.ImuBias(bg1 + d1[9:12], ba1 + d1[12:15])
    r_in = pre.inertial_residual(m, lie.se3_rot(T1p), v1 + d1[6:9], lie.se3_trans(T1p),
                                 lie.se3_rot(T2p), v2 + d2[6:9], lie.se3_trans(T2p), b1, g=g)
    r = torch.cat([r_in, bg2 + d2[9:12] - b1.bg, ba2 + d2[12:15] - b1.ba])
    return r, r


def _pair_inputs(P: VIBAProblem):
    i, j = P.pair_i, P.pair_j
    zero = torch.zeros((i.shape[0], 2 * S), dtype=P.Twb.dtype, device=P.Twb.device)
    return (zero, P.Twb[i], P.Twb[j], P.vel[i], P.vel[j], P.bg[i], P.ba[i], P.bg[j], P.ba[j],
            P.pair_meas)


def _pair_weights(P: VIBAProblem, dtype) -> torch.Tensor:
    info_in = (1.0 / torch.diagonal(P.pair_meas.cov, dim1=-2, dim2=-1).clamp_min(1e-10)
               ).clamp_max(1e8)
    w = torch.cat([info_in, P.info_bg[:, None].expand(-1, 3), P.info_ba[:, None].expand(-1, 3)],
                  dim=-1).to(dtype)
    return torch.where(P.pair_valid[:, None], w, 0.0)


def _inertial_linearize(P: VIBAProblem):
    """Each pair's 15 residuals with their Jacobian (15 × 30) in both
    states, one forward-mode pass over the 30 directions, batched over the
    pairs. Returns r (P, 15), J (P, 15, 30), w (P, 15), the cost."""
    g = pre.gravity_vec(P.Twb.dtype, P.Twb.device)

    def one(d, *pair):
        return torch.func.jacfwd(lambda dd: _pair_residual(dd, *pair, g), has_aux=True)(d)

    J, r = torch.func.vmap(one)(*_pair_inputs(P))
    w = _pair_weights(P, r.dtype)
    return r, J, w, torch.sum(w * r * r)


def _inertial_cost(P: VIBAProblem) -> torch.Tensor:
    """The inertial cost alone (no Jacobian)."""
    g = pre.gravity_vec(P.Twb.dtype, P.Twb.device)
    r = torch.func.vmap(lambda *a: _pair_residual(*a, g)[0])(*_pair_inputs(P))
    return torch.sum(_pair_weights(P, r.dtype) * r * r)


def _diag_part(A: torch.Tensor) -> torch.Tensor:
    return torch.diag_embed(torch.diagonal(A, dim1=-2, dim2=-1))


def _build_and_solve(P: VIBAProblem, r, Jp, Jl, w, r_in, J_in, w_in, lam):
    """One damped joint step: landmark Schur complement plus the dense
    reduced state system. Returns (dx (K, 15), dl (M, 3))."""
    K = P.Twb.shape[0]
    M, D = P.obs_kf.shape
    dtype, dev = r.dtype, r.device
    eye3 = torch.eye(3, dtype=dtype, device=dev)

    # visual pose Jacobians widened to the 15-wide state blocks (cols 0:6)
    Jp15 = torch.nn.functional.pad(Jp, (0, S - 6))               # (M, D, 3, 15)
    wJp = w[..., None, None] * Jp15
    wJl = w[..., None, None] * Jl
    onehot = torch.nn.functional.one_hot(P.obs_kf, K).to(dtype)  # (M, D, K)
    per_obs = torch.cat([(wJp.transpose(-1, -2) @ Jp15).reshape(M * D, S * S),
                         (wJp.transpose(-1, -2) @ r[..., None]).reshape(M * D, S)], dim=1)
    sums = onehot.reshape(M * D, K).T @ per_obs                  # (K, 240)
    U = sums[:, :S * S].reshape(K, S, S)
    b_s = sums[:, S * S:]

    V = torch.sum(Jl.transpose(-1, -2) @ wJl, dim=1)             # (M, 3, 3)
    b_l = torch.sum(wJl.transpose(-1, -2) @ r[..., None], dim=1)[..., 0]
    Wpl = Jp15.transpose(-1, -2) @ wJl                           # (M, D, 15, 3)

    V_d = V + (lam * _diag_part(V) + 1e-8 * eye3)
    V_d = torch.where(P.lm_valid[:, None, None], V_d, eye3)
    Vinv = torch.linalg.inv_ex(V_d)[0]

    G = (onehot.transpose(1, 2) @ Wpl.reshape(M, D, S * 3)).reshape(M, K, S, 3)
    L = torch.linalg.cholesky_ex(Vinv + 1e-12 * eye3)[0]
    C = G.reshape(M, K * S, 3) @ L
    C2 = C.transpose(0, 1).reshape(K * S, M * 3)
    S_cross = C2 @ C2.T
    Vinv_bl = (Vinv @ b_l[..., None])[..., 0]
    b_cross = torch.einsum("mkjl,ml->kj", G, Vinv_bl)

    # inertial blocks, reduced onto the states by the pairs' one-hot rows
    Pn = P.pair_i.shape[0]
    oh_i = torch.nn.functional.one_hot(P.pair_i, K).to(dtype)    # (P, K)
    oh_j = torch.nn.functional.one_hot(P.pair_j, K).to(dtype)
    J1, J2 = J_in[..., :S], J_in[..., S:]
    wJ1 = w_in[..., None] * J1
    wJ2 = w_in[..., None] * J2
    H11 = oh_i.T @ (wJ1.transpose(-1, -2) @ J1).reshape(Pn, S * S)
    H22 = oh_j.T @ (wJ2.transpose(-1, -2) @ J2).reshape(Pn, S * S)
    b1 = oh_i.T @ (wJ1.transpose(-1, -2) @ r_in[..., None]).reshape(Pn, S)
    b2 = oh_j.T @ (wJ2.transpose(-1, -2) @ r_in[..., None]).reshape(Pn, S)
    H12 = (wJ1.transpose(-1, -2) @ J2).reshape(Pn, S * S)        # (P, 225)
    H_off = (oh_i.T @ (oh_j[:, :, None] * H12[:, None, :]).reshape(Pn, K * S * S)
             ).reshape(K, K, S, S).permute(0, 2, 1, 3)           # (K, 15, K, 15)

    U_tot = U + (H11 + H22).reshape(K, S, S)
    U_damped = U_tot + lam * _diag_part(U_tot)
    eye_k = torch.eye(K, dtype=dtype, device=dev)
    H_full = torch.einsum("kab,kl->kalb", U_damped, eye_k)      # block diagonal
    H_full = H_full + H_off + H_off.permute(2, 3, 0, 1)
    H_full = H_full.reshape(K * S, K * S) - S_cross
    rhs = (b_s + b1 + b2 - b_cross).reshape(K * S)

    freeS = ((~P.state_fixed) & P.state_valid).repeat_interleave(S)
    H_full = torch.where(freeS[:, None] & freeS[None, :], H_full, 0.0)
    H_full = H_full + torch.diag(torch.where(freeS, 1e-7, 1.0).to(dtype))
    rhs = torch.where(freeS, rhs, 0.0)

    dx = -torch.linalg.solve_ex(H_full, rhs[:, None])[0][:, 0].reshape(K, S)
    dx_obs = dx[P.obs_kf]                                        # (M, D, 15)
    Wt_dx = torch.sum(Wpl.transpose(-1, -2) @ dx_obs[..., None], dim=1)[..., 0]
    dl = -(Vinv @ (b_l + Wt_dx)[..., None])[..., 0]
    dl = torch.where(P.lm_valid[:, None], dl, 0.0)
    return dx, dl


def vi_bundle_adjust(problem: VIBAProblem, cam: PinholeCamera, iterations: int = 8,
                     huber_iters: int = 5) -> VIBAResult:
    """Damped joint Gauss-Newton over the window's states and landmarks
    (LM accept/reject), the reference's protocol: a robust phase, an
    outlier cull, a final chi² classification. Nothing in it waits for the
    card; the caller downloads the result once."""
    dtype, dev = problem.Twb.dtype, problem.Twb.device
    chi2_th = torch.where(problem.obs_ur >= 0, CHI2_STEREO, CHI2_MONO)

    P = problem
    lam = torch.full((), 1e-3, dtype=dtype, device=dev)
    obs_active = problem.obs_mask
    cost = torch.full((), float("inf"), dtype=dtype, device=dev)
    for it in range(iterations):
        use_huber = it < huber_iters
        r, Jp, Jl, w, chi2, active, cost_v = _visual_linearize(P, cam, use_huber, obs_active)
        r_in, J_in, w_in, cost_i = _inertial_linearize(P)
        dx, dl = _build_and_solve(P, r, Jp, Jl, w, r_in, J_in, w_in, lam)
        P_new = _apply_state_delta(P, dx)._replace(landmarks=P.landmarks + dl)
        c_new = (_visual_linearize(P_new, cam, use_huber, obs_active)[-1]
                 + _inertial_cost(P_new))
        c_old = cost_v + cost_i
        # reject diverged (NaN, cost-collapse) steps
        accept = (c_new < c_old) & torch.isfinite(c_new)
        P = P._replace(**{f: torch.where(accept, getattr(P_new, f), getattr(P, f))
                          for f in ("Twb", "vel", "bg", "ba", "landmarks")})
        lam = torch.where(accept, (lam * 0.5).clamp_min(1e-10), (lam * 4.0).clamp_max(1e4))
        if it == huber_iters - 1:
            r3 = _visual_linearize(P, cam, False, obs_active)[0]
            chi2_now = torch.sum(r3 * r3, dim=-1) * problem.obs_inv_sigma2
            obs_active = obs_active & (chi2_now <= 2.0 * chi2_th)
        cost = torch.where(accept, c_new, c_old)

    _, _, _, _, chi2, active, _ = _visual_linearize(P, cam, False,
                                                    torch.ones_like(problem.obs_mask))
    return VIBAResult(Twb=P.Twb, vel=P.vel, bg=P.bg, ba=P.ba, landmarks=P.landmarks,
                      obs_inlier=active & (chi2 <= chi2_th), cost=cost)
