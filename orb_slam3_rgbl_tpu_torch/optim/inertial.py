"""Visual-inertial optimization (counterpart of
``orb_slam3_rgbl_tpu.optim.inertial``; reference ``Optimizer``'s inertial
entry points).

* ``PoseInertialOptimizationLastKeyFrame`` → :func:`inertial_pose_optimize`:
  the current frame's 15-DoF state [pose, velocity, gyro bias, accel bias]
  against reprojection factors, the preintegration factor to the last
  keyframe and bias random-walk priors.
* ``PoseInertialOptimizationLastFrame`` with the carried marginalization
  prior → :func:`inertial_pose_optimize_prior`: a joint 30-DoF solve of the
  previous and the current frame.
* ``InertialOptimization`` → :func:`imu_initialization`: gravity direction,
  scale, biases and per-keyframe velocities from visual keyframe poses and
  preintegrated windows.

The Jacobians are forward-mode autodiff of the residual stacks
(``torch.func.jacfwd``), as the JAX package's ``jax.jacfwd``, so both
packages linearize alike. Every solve is
``solve_ex`` and every accept decision a ``torch.where`` on device tensors:
nothing waits for the card. The linear bootstrap of the IMU initialization
solves its least squares by float64 normal equations with a vanishing ridge
(the minimum-norm solution the JAX package's SVD ``lstsq`` gives, without
the SVD's wait for the card).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orb_slam3_rgbl_tpu_torch.geometry import lie
from orb_slam3_rgbl_tpu_torch.geometry.camera import PinholeCamera, geo_project, is_fisheye
from orb_slam3_rgbl_tpu_torch.imu import preintegration as pre
from orb_slam3_rgbl_tpu_torch.optim.pose_opt import CHI2_MONO, CHI2_STEREO, PoseObs


class VIState(NamedTuple):
    """World-frame body state (the reference's VertexPose, VertexVelocity,
    VertexGyroBias and VertexAccBias)."""

    Twb: torch.Tensor   # (7,) body → world SE3
    vw: torch.Tensor    # (3,) world velocity
    bias: pre.ImuBias


def _rep3(x: torch.Tensor) -> torch.Tensor:
    """Each element three times (``jnp.repeat(x, 3)``)."""
    return x[:, None].expand(-1, 3).reshape(-1)


def _jacobian(residual_fn, x: torch.Tensor):
    """(J, r, w) of ``residual_fn(x)`` → (r, w) at ``x``, J by forward-mode
    autodiff (``torch.func.jacfwd``)."""
    def f(xx):
        r, w = residual_fn(xx)
        return r, (r, w)
    J, (r, w) = torch.func.jacfwd(f, has_aux=True)(x)
    return J, r, w


def _weighted_gn_step(residual_fn, x0: torch.Tensor, lam: torch.Tensor):
    """One damped Gauss-Newton step on a flat parameter vector
    (``residual_fn(x)`` → (r, w)). Returns (dx, cost at x0)."""
    J, r, w = _jacobian(residual_fn, x0)
    dim = x0.shape[0]
    H = J.T @ (w[:, None] * J) + lam * torch.eye(dim, dtype=x0.dtype, device=x0.device)
    b = J.T @ (w * r)
    return -torch.linalg.solve_ex(H, b[:, None])[0][:, 0], torch.sum(w * r * r)


def _hessian(residual_fn, x: torch.Tensor) -> torch.Tensor:
    J, _, w = _jacobian(residual_fn, x)
    return J.T @ (w[:, None] * J)


class _Obs(NamedTuple):
    """The float fields of ``PoseObs``."""
    Xw: torch.Tensor
    uv: torch.Tensor
    u_right: torch.Tensor
    inv_sigma2: torch.Tensor


def _f32_obs(obs: PoseObs, dtype) -> _Obs:
    return _Obs(Xw=obs.Xw.to(dtype), uv=obs.uv.to(dtype), u_right=obs.u_right.to(dtype),
                inv_sigma2=obs.inv_sigma2.to(dtype))


def _project(obs: _Obs, Twb, T_cb, cam):
    """Pixel prediction of every observation through Tcw = T_cb · Twb⁻¹:
    (u, v, uR, is_stereo, camera-frame depth)."""
    Tcw = lie.se3_mul(T_cb, lie.se3_inv(Twb))
    pc = lie.se3_apply(Tcw, obs.Xw)
    z = torch.where(pc[:, 2].abs() < 1e-6, 1e-6, pc[:, 2])
    uvh = geo_project(cam, pc)
    u, v = uvh[:, 0], uvh[:, 1]
    is_stereo = obs.u_right >= 0
    if is_fisheye(cam):                  # fisheye observations are always mono
        is_stereo = torch.zeros_like(is_stereo)
    ur = u - cam.bf / z
    return u, v, ur, is_stereo, pc[:, 2]


def _visual_residual(obs: _Obs, Twb, T_cb, cam, visual_active):
    u, v, ur, is_stereo, pz = _project(obs, Twb, T_cb, cam)
    r = torch.stack([obs.uv[:, 0] - u, obs.uv[:, 1] - v,
                     torch.where(is_stereo, obs.u_right - ur, 0.0)], dim=-1).reshape(-1)
    w = _rep3(torch.where(visual_active & (pz > 1e-3), obs.inv_sigma2, 0.0))
    return r, w


def _chi2_visual(obs: _Obs, Twb, T_cb, cam):
    u, v, ur, is_stereo, pz = _project(obs, Twb, T_cb, cam)
    e2 = ((obs.uv[:, 0] - u) ** 2 + (obs.uv[:, 1] - v) ** 2
          + torch.where(is_stereo, (obs.u_right - ur) ** 2, 0.0))
    return e2 * obs.inv_sigma2, is_stereo, pz > 1e-3


def _unpack_state(base: VIState, d: torch.Tensor) -> VIState:
    Twb = lie.se3_mul(lie.se3_exp(d[0:6]), base.Twb)
    return VIState(Twb, base.vw + d[6:9],
                   pre.ImuBias(base.bias.bg + d[9:12], base.bias.ba + d[12:15]))


def _inertial_info(meas: pre.Preintegrated) -> torch.Tensor:
    """Diagonal information of the preintegration covariance, capped: the
    joint f32 system stays conditioned over long windows."""
    return (1.0 / torch.diagonal(meas.cov).clamp_min(1e-10)).clamp_max(1e6)


def _pair_residual(meas, p: VIState, s: VIState, g) -> torch.Tensor:
    return pre.inertial_residual(meas, lie.se3_rot(p.Twb), p.vw, lie.se3_trans(p.Twb),
                                 lie.se3_rot(s.Twb), s.vw, lie.se3_trans(s.Twb), s.bias, g=g)


def _robust_rounds(residuals, valid, chi2_of, x, lam, iterations: int, rounds: int = 2):
    """``rounds`` × ``iterations`` damped steps with accept/reject; after
    each round the visual observations are re-classified by chi².
    ``residuals(x, active)``."""
    active = valid
    for _ in range(rounds):
        def res(xx, _active=active):
            return residuals(xx, _active)
        for _ in range(iterations):
            dx, cost = _weighted_gn_step(res, x, lam)
            x_new = x + dx
            r2, w2 = res(x_new)
            c_new = torch.sum(w2 * r2 * r2)
            ok = (c_new < cost) & torch.isfinite(c_new)
            x = torch.where(ok, x_new, x)
            lam = torch.where(ok, lam * 0.5, lam * 4.0)
        chi2, is_stereo, depth_ok = chi2_of(x)
        th = torch.where(is_stereo, CHI2_STEREO, CHI2_MONO)
        active = valid & depth_ok & (chi2 <= th)
    return x, active


def inertial_pose_optimize(state0: VIState, prev: VIState, meas: pre.Preintegrated,
                           obs: PoseObs, T_cb: torch.Tensor, cam: PinholeCamera,
                           info_bias_g: float = 1e5, info_bias_a: float = 1e4,
                           iterations: int = 8):
    """Optimize the current frame's 15-DoF state against the fixed previous
    keyframe ``prev`` (``meas``: its preintegration to the current frame).
    The camera pose is T_cb · Twb⁻¹. Returns (VIState, n_visual_inliers,
    H_cur (15, 15)): the current state's Hessian at the solution, the seed
    of the marginalization-prior chain (``ConstraintPoseImu``)."""
    dtype, dev = state0.Twb.dtype, state0.Twb.device
    o = _f32_obs(obs, dtype)
    w_tail = torch.cat([_inertial_info(meas),
                        torch.full((3,), info_bias_g, dtype=dtype, device=dev),
                        torch.full((3,), info_bias_a, dtype=dtype, device=dev)])
    g = pre.gravity_vec(dtype, dev)

    def residuals(x, visual_active):
        s = _unpack_state(state0, x)
        r_vis, w_vis = _visual_residual(o, s.Twb, T_cb, cam, visual_active)
        r_in = _pair_residual(meas, prev, s, g)
        r = torch.cat([r_vis, r_in, s.bias.bg - prev.bias.bg, s.bias.ba - prev.bias.ba])
        return r, torch.cat([w_vis, w_tail])

    def chi2_of(x):
        return _chi2_visual(o, _unpack_state(state0, x).Twb, T_cb, cam)

    x, active = _robust_rounds(residuals, obs.valid, chi2_of,
                               torch.zeros(15, dtype=dtype, device=dev),
                               torch.full((), 1e-2, dtype=dtype, device=dev), iterations)
    H_cur = _hessian(lambda xx: residuals(xx, active), x)
    return _unpack_state(state0, x), active.sum().to(torch.int32), H_cur


def inertial_pose_optimize_prior(state0: VIState, prev0: VIState, prior_sqrt_info: torch.Tensor,
                                 meas: pre.Preintegrated, obs: PoseObs, T_cb: torch.Tensor,
                                 cam: PinholeCamera, info_bias_g: float = 1e5,
                                 info_bias_a: float = 1e4, iterations: int = 8):
    """``PoseInertialOptimizationLastFrame`` with the carried
    marginalization prior (``EdgePriorPoseImu`` from ``mpcpi``): a joint
    30-DoF solve of [previous frame, current frame], the previous state held
    by the last solve's marginal information about ``prev0`` instead of
    fixed. ``prior_sqrt_info``: (15, 15) L with H_prior = L Lᵀ; the prior
    residual Lᵀ·δ_prev keeps the weights diagonal.

    Returns (current VIState, previous VIState, n_visual_inliers, H_marg
    (15, 15)): the current state's marginal Hessian with the previous state
    Schur-eliminated, the next frame's prior (``Optimizer::Marginalize``)."""
    dtype, dev = state0.Twb.dtype, state0.Twb.device
    o = _f32_obs(obs, dtype)
    w_tail = torch.cat([_inertial_info(meas),
                        torch.full((3,), info_bias_g, dtype=dtype, device=dev),
                        torch.full((3,), info_bias_a, dtype=dtype, device=dev),
                        torch.ones(15, dtype=dtype, device=dev)])
    g, L = pre.gravity_vec(dtype, dev), prior_sqrt_info.to(dtype)

    def residuals(x, visual_active):
        p, s = _unpack_state(prev0, x[:15]), _unpack_state(state0, x[15:])
        r_vis, w_vis = _visual_residual(o, s.Twb, T_cb, cam, visual_active)
        r_in = _pair_residual(meas, p, s, g)
        r = torch.cat([r_vis, r_in, s.bias.bg - p.bias.bg, s.bias.ba - p.bias.ba,
                       L.T @ x[:15]])        # δᵀ L Lᵀ δ = δᵀ H_prior δ
        return r, torch.cat([w_vis, w_tail])

    def chi2_of(x):
        return _chi2_visual(o, _unpack_state(state0, x[15:]).Twb, T_cb, cam)

    x, active = _robust_rounds(residuals, obs.valid, chi2_of,
                               torch.zeros(30, dtype=dtype, device=dev),
                               torch.full((), 1e-2, dtype=dtype, device=dev), iterations)
    # marginalize the previous state out of the joint Hessian
    H = _hessian(lambda xx: residuals(xx, active), x)
    H_pp = H[:15, :15] + 1e-6 * torch.eye(15, dtype=dtype, device=dev)
    H_pc = H[:15, 15:]
    H_marg = H[15:, 15:] - H_pc.T @ torch.linalg.solve_ex(H_pp, H_pc)[0]
    return (_unpack_state(state0, x[15:]), _unpack_state(prev0, x[:15]),
            active.sum().to(torch.int32), H_marg)


def _min_norm_lstsq(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The least-squares solution of A x = b, minimum-norm where A is rank
    deficient: float64 normal equations with a ridge 1e-12 of their largest
    diagonal entry."""
    A64, b64 = A.to(torch.float64), b.to(torch.float64)
    AtA = A64.T @ A64
    ridge = 1e-12 * torch.diagonal(AtA).max().clamp_min(1e-30)
    AtA = AtA + ridge * torch.eye(A.shape[1], dtype=torch.float64, device=A.device)
    return torch.linalg.solve_ex(AtA, (A64.T @ b64)[:, None])[0][:, 0].to(A.dtype)


def imu_initialization(Twb: torch.Tensor, meas: pre.Preintegrated, valid_pair: torch.Tensor,
                       prior_g: float = 1e2, prior_a: float = 1e6, iterations: int = 40,
                       fix_scale: bool = False) -> dict:
    """Gravity direction, metric scale, shared biases and per-keyframe
    velocities from up-to-scale visual body poses ``Twb`` (K, 7) and the
    stacked preintegrations ``meas`` (K − 1) of consecutive keyframes
    (``InertialOptimization``; ``prior_g`` / ``prior_a`` are the priorG /
    priorA of ``LocalMapping::InitializeIMU``). Three stages: gyro bias from
    the rotation residuals alone, a linear bootstrap of velocities, gravity
    and scale, then a joint refinement with |g| = 9.81.

    Returns dict(Rwg quaternion, scale, bias, velocities (K, 3), cost)."""
    K = Twb.shape[0]
    dtype, dev = Twb.dtype, Twb.device
    g0 = pre.gravity_vec(dtype, dev)
    q_all, p_all = lie.se3_rot(Twb), lie.se3_trans(Twb)
    q1, q2 = q_all[:-1], q_all[1:]
    R1m = lie.quat_to_matrix(lie.quat_conj(q1))              # (K−1, 3, 3)
    rel = lie.quat_mul(lie.quat_conj(q1), q2)
    dt = meas.dt                                             # (K−1,)
    info = (1.0 / torch.diagonal(meas.cov, dim1=-2, dim2=-1).clamp_min(1e-10))
    w_pairs = torch.where(valid_pair[:, None], info, 0.0).reshape(-1)
    z3 = torch.zeros(3, dtype=dtype, device=dev)

    def unpack(x):
        Rwg = lie.so3_exp(torch.cat([x[0:2], x[0:1] * 0.0]))   # 2-dof gravity rotation
        s = torch.ones((), dtype=dtype, device=dev) if fix_scale else torch.exp(x[2])
        return Rwg, s, pre.ImuBias(x[3:6], x[6:9]), x[9:].reshape(K, 3)

    wts = torch.cat([w_pairs, torch.full((3,), prior_g, dtype=dtype, device=dev),
                     torch.full((3,), prior_a, dtype=dtype, device=dev)])
    # normalized: the preintegration information spans ~1e10 (1/cov of a
    # short window), which wrecks f32 normal equations; weighted least
    # squares is invariant to a uniform scale of its weights
    wts = wts / wts.max().clamp_min(1e-12)

    dp_w = p_all[1:] - p_all[:-1]

    def residuals(x):
        Rwg, s, bias, vel = unpack(x)
        g = lie.quat_rotate(Rwg, g0)
        v1, v2 = vel[:-1], vel[1:]
        er = lie.so3_log(lie.quat_mul(lie.quat_conj(pre.delta_rotation(meas, bias)), rel))
        ev = ((R1m @ (v2 - v1 - g * dt[:, None])[..., None])[..., 0]
              - pre.delta_velocity(meas, bias))
        dp = s * dp_w - v1 * dt[:, None] - 0.5 * g * (dt * dt)[:, None]
        ep = (R1m @ dp[..., None])[..., 0] - pre.delta_position(meas, bias)
        r = torch.cat([torch.cat([er, ev, ep], dim=-1).reshape(-1), x[3:6], x[6:9]])
        return r, wts

    # ---- stage A: the gyro bias from the rotation residuals alone ----------
    ones = torch.ones((K - 1) * 3, dtype=dtype, device=dev)

    def rot_residuals(bg):
        r = lie.so3_log(lie.quat_mul(
            lie.quat_conj(pre.delta_rotation(meas, pre.ImuBias(bg, bg * 0.0))), rel))
        return torch.where(valid_pair[:, None], r, 0.0).reshape(-1), ones

    bg0 = z3
    lam_a = torch.full((), 1e-8, dtype=dtype, device=dev)
    for _ in range(3):
        dbg, _ = _weighted_gn_step(rot_residuals, bg0, lam_a)
        bg0 = bg0 + dbg

    # ---- stage B: velocities, gravity (3-dof) and scale, linear given the
    # rotations and the gyro bias ------------------------------------------
    bias_lin = pre.ImuBias(bg0, z3)
    eye_k = torch.eye(K, dtype=dtype, device=dev)
    sel_i, sel_j = eye_k[:-1], eye_k[1:]                     # (K−1, K) one-hot rows
    R1dt = R1m * dt[:, None, None]

    def spread(sel, M):
        """(K−1, 3, 3K): block M[p] at keyframe column sel[p]."""
        return torch.einsum("pk,pab->pakb", sel, M).reshape(K - 1, 3, 3 * K)

    zero_col = torch.zeros((K - 1, 3, 1), dtype=dtype, device=dev)
    dp_vis = (R1m @ (p_all[1:] - p_all[:-1])[..., None])     # (K−1, 3, 1)
    rows_v = torch.cat([spread(sel_i, -R1m) + spread(sel_j, R1m), -R1dt, zero_col], dim=-1)
    rows_p = torch.cat([spread(sel_i, -R1dt), -0.5 * R1dt * dt[:, None, None], dp_vis], dim=-1)
    ok = valid_pair.to(dtype)[:, None, None]
    A = (torch.cat([rows_v, rows_p], dim=1) * ok).reshape(6 * (K - 1), 3 * K + 4)
    b = (torch.cat([pre.delta_velocity(meas, bias_lin), pre.delta_position(meas, bias_lin)],
                   dim=-1) * ok[:, :, 0]).reshape(-1)
    if fix_scale:
        # the scale column (s = 1) moves to the right-hand side
        b = b - A[:, -1]
        A = torch.cat([A[:, :-1], torch.zeros_like(A[:, -1:])], dim=1)
    sol = _min_norm_lstsq(A, b)
    vel0 = sol[: 3 * K]
    g_lin = sol[3 * K:3 * K + 3]
    s_lin = sol[3 * K + 3].clamp_min(1e-3)

    # gravity direction → the 2-dof rotation from (0, 0, −g): axis ĝ0 × ĝ
    g_hat = g_lin / torch.linalg.norm(g_lin).clamp_min(1e-9)
    g0_hat = g0 / pre.GRAVITY
    axis = lie._cross(g0_hat, g_hat)
    sin_a = torch.linalg.norm(axis)
    angle = torch.atan2(sin_a, torch.dot(g0_hat, g_hat))
    w_g = axis / sin_a.clamp_min(1e-9) * angle

    # ---- stage C: joint refinement with |g| fixed at 9.81 ------------------
    log_s = torch.zeros_like(s_lin) if fix_scale else torch.log(s_lin)
    x = torch.cat([w_g[:2], log_s[None], bg0, z3, vel0])
    lam = torch.full((), 1e-2, dtype=dtype, device=dev)
    cost = torch.full((), float("inf"), dtype=dtype, device=dev)
    for _ in range(iterations):
        dx, c0 = _weighted_gn_step(residuals, x, lam)
        x_new = x + dx
        r2, w2 = residuals(x_new)
        c_new = torch.sum(w2 * r2 * r2)
        ok = (c_new < c0) & torch.isfinite(c_new)
        x = torch.where(ok, x_new, x)
        lam = torch.where(ok, (lam * 0.5).clamp_min(1e-9), (lam * 5.0).clamp_max(1e5))
        cost = torch.where(ok, c_new, c0)
    Rwg, s, bias, vel = unpack(x)
    return {"Rwg": Rwg, "scale": s, "bias": bias, "velocities": vel, "cost": cost}
