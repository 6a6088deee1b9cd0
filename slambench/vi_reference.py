"""Plain reference of the whole-map visual-inertial bundle adjustment that
the loop closer runs after a correction on an inertial map (ORB-SLAM3's
``Optimizer::FullInertialBA(7)``, ``LoopClosing.cc:2284-2287``, as the
port schedules it): Levenberg-Marquardt over every keyframe's body state
and every landmark, each step's normal equations solved by a fixed number
of block-Jacobi preconditioned conjugate-gradient steps.

Plain PyTorch over flat lists of the observations and of the pairs, with
rotation matrices: it imports neither JAX nor anything of the program (only
numpy, torch and the benchmark's ``mapgen``, ``vi_mapgen`` and
``reference``) and builds its problem from the map's raw arrays
(``vi_mapgen.generate``'s dict). Sums onto keyframes and landmarks go
through fixed tables (``Sums``), so two runs give the same bits.
``reference.Arith`` says how it computes: float64 for the reference;
float32 with every matrix product's operands rounded to TF32 for the
control (the pairs' Jacobians are then forward-mode derivatives in float32
without that rounding). TF32 is switched off in PyTorch while it runs.

The semantics it follows, those of the program's solve:

* a state per keyframe: the body pose Twb = Tcw⁻¹ · T_cb (T_cb the inverse
  of ``IMU.T_b_c1``), its world velocity, gyro bias bg and accelerometer
  bias ba; 15 tangent dimensions [ρ, ω, v, bg, ba], the pose updated on the
  left, R ← Exp(ω) R, p ← Exp(ω) p + J_l(ω) ρ; the first state fixed whole;
  a landmark X ← X + δX;
* the visual residual r = (u, v, u_R) observed − predicted through
  T_cw = T_cb · Twb⁻¹, the third row only with a right coordinate;
  χ² = |r|² / σ²(octave); weight 1/σ² × Huber (δ² = 7.815 with u_R, 5.991
  without) where the point is in front of the camera (z > 1e-3), else 0;
  cost Σ w_rob min(χ², 1e7) over those;
* a pair (keyframe k, k + 1) with its preintegration (ΔR, Δv, Δp, their
  bias Jacobians at the bias b₀ it was integrated at, the 9×9 covariance
  Σ): Forster's residual, with δbg = bg₁ − bg₀, δba = ba₁ − ba₀,
    r_R = Log((ΔR · Exp(J_Rg δbg))ᵀ R₁ᵀ R₂),
    r_v = R₁ᵀ (v₂ − v₁ − g Δt) − (Δv + J_Vg δbg + J_Va δba),
    r_p = R₁ᵀ (p₂ − p₁ − v₁ Δt − ½ g Δt²) − (Δp + J_Pg δbg + J_Pa δba),
  g = (0, 0, −9.81), and the bias walks bg₂ − bg₁, ba₂ − ba₁; weights
  min(1 / max(Σ_ii, 1e-10), 1e8) and min(1 / max(walk² Δt, 1e-12), 1e8)
  (Δt at least 1e-3); cost Σ w r²; its Jacobian in both states (15 × 30) by
  forward-mode autodiff at the current states;
* PCG on (JᵀWJ + λ diag(JᵀWJ) + 1e-7 I) x = −JᵀWr from x = 0, the
  preconditioner the inverse of each state's 15×15 (visual and pairs) and
  each landmark's 3×3 damped diagonal block; α = rz / max(pAp, 1e-20),
  β = rz' / max(rz, 1e-20);
* a step is kept when the total cost is lower, finite, and keeps at least
  half of the active observations; λ then × 0.4 (≥ 1e-8), else × 5
  (≤ 1e4), from 1e-3; Huber weights while the iteration is below
  ``huber_iterations``; the reported cost is the plain one (no Huber);
* each landmark keeps at most ``max_obs`` observations, as
  ``reference.observations`` keeps them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slambench import vi_mapgen
from slambench.mapgen import quat_to_matrix
from slambench.reference import CHI2_MONO, CHI2_STEREO, Arith, hat, observations, so3_exp

GRAVITY = 9.81
S = 15


class Sums:
    """Sums of per-item values onto ``n`` targets in a fixed order: a
    (n, L) table of the items of each target, unused slots pointing at an
    appended zero row."""

    def __init__(self, index: np.ndarray, n: int, device):
        index = np.asarray(index, np.int64)
        order = np.argsort(index, kind="stable")
        counts = np.bincount(index, minlength=n)
        L = max(int(counts.max()) if n else 1, 1)
        rank = np.arange(len(index)) - np.repeat(np.cumsum(counts) - counts, counts)
        table = np.full((n, L), len(index), np.int64)
        table[index[order], rank] = order
        self.table = torch.as_tensor(table, device=device)

    def __call__(self, values: torch.Tensor) -> torch.Tensor:
        flat = torch.cat([values, torch.zeros_like(values[:1])], dim=0)
        return flat[self.table].sum(dim=1)


class Problem(NamedTuple):
    R: torch.Tensor          # (K, 3, 3) body → world
    p: torch.Tensor          # (K, 3)
    vel: torch.Tensor        # (K, 3)
    bg: torch.Tensor         # (K, 3)
    ba: torch.Tensor         # (K, 3)
    X: torch.Tensor          # (M, 3)
    free: torch.Tensor       # (K, 1) bool
    R_cb: torch.Tensor       # (3, 3) body → camera
    t_cb: torch.Tensor       # (3,)
    obs_kf: torch.Tensor     # (n,) int64
    obs_lm: torch.Tensor     # (n,)
    uv: torch.Tensor         # (n, 2)
    ur: torch.Tensor         # (n,)
    inv_s2: torch.Tensor     # (n,)
    pair_i: torch.Tensor     # (P,) int64
    pair_j: torch.Tensor     # (P,)
    pre: dict                # the pairs' preintegrations, ΔR as matrices
    w_pair: torch.Tensor     # (P, 15)


def build_problem(maparr: dict, config: dict, inv_sigma2: np.ndarray, max_obs: int,
                  arith: Arith, device, pair_valid=None) -> Problem:
    kf, lm, feat = observations(maparr, max_obs)
    K = len(maparr["kf_pose"])
    R_cw = quat_to_matrix(maparr["kf_pose"][:, :4])
    t_cw = np.asarray(maparr["kf_pose"][:, 4:7], np.float64)
    T_bc = vi_mapgen.matrix44(config["imu"]["T_b_c1"])
    R_cb, t_cb = T_bc[:3, :3].T, -T_bc[:3, :3].T @ T_bc[:3, 3]
    # Twb = Tcw⁻¹ · T_cb
    R_wb = np.swapaxes(R_cw, -1, -2) @ R_cb
    p_wb = np.einsum("kji,kj->ki", R_cw, t_cb[None] - t_cw)
    free = np.ones((K, 1), bool)
    free[0] = False

    pre = vi_mapgen.unflatten(maparr["preint"])
    P = len(pre["dt"])
    imu = config["imu"]
    dts = np.maximum(pre["dt"], 1e-3)
    info_in = np.minimum(1.0 / np.maximum(np.diagonal(pre["cov"], axis1=1, axis2=2), 1e-10), 1e8)
    info_bg = np.minimum(1.0 / np.maximum(imu["gyro_walk"] ** 2 * dts, 1e-12), 1e8)
    info_ba = np.minimum(1.0 / np.maximum(imu["acc_walk"] ** 2 * dts, 1e-12), 1e8)
    w_pair = np.concatenate([info_in, np.repeat(info_bg[:, None], 3, 1),
                             np.repeat(info_ba[:, None], 3, 1)], 1)
    if pair_valid is not None:
        w_pair = np.where(np.asarray(pair_valid, bool)[:, None], w_pair, 0.0)

    def up(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype or arith.dtype, device=device)

    pre_t = {k: up(v) for k, v in pre.items() if k != "dR"}
    pre_t["dR"] = up(quat_to_matrix(pre["dR"]))
    return Problem(
        R=up(R_wb), p=up(p_wb), vel=up(maparr["kf_vel"]), bg=up(maparr["kf_bg"]),
        ba=up(maparr["kf_ba"]), X=up(maparr["lm_pos"]), free=up(free, torch.bool),
        R_cb=up(R_cb), t_cb=up(t_cb), obs_kf=up(kf, torch.int64), obs_lm=up(lm, torch.int64),
        uv=up(maparr["kf_uv"][kf, feat]), ur=up(maparr["kf_ur"][kf, feat]),
        inv_s2=up(inv_sigma2[maparr["kf_octave"][kf, feat]]),
        pair_i=up(np.arange(P), torch.int64), pair_j=up(np.arange(1, P + 1), torch.int64),
        pre=pre_t, w_pair=up(w_pair))


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation vectors of rotations (angle below π), differentiable."""
    v = 0.5 * torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                           R[..., 1, 0] - R[..., 0, 1]], -1)
    s2 = (v * v).sum(-1)
    c = 0.5 * (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1.0)
    small = s2 < 1e-14
    safe = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    f = torch.where(small, 1.0 + s2 / 6.0, torch.atan2(safe, c) / safe)
    return f[..., None] * v


def _mv(A, v):
    return (A @ v[..., None])[..., 0]


def pair_residual(d, R1, p1, v1, bg1, ba1, R2, p2, v2, bg2, ba2, pre):
    """The 15 residuals of one pair at the tangent d (30,) of both states."""
    plain = Arith(d.dtype)
    Ra, Ja = so3_exp(d[3:6], plain)
    Rb, Jb = so3_exp(d[18:21], plain)
    R1n, p1n = Ra @ R1, _mv(Ra, p1) + _mv(Ja, d[0:3])
    R2n, p2n = Rb @ R2, _mv(Rb, p2) + _mv(Jb, d[15:18])
    v1n, v2n = v1 + d[6:9], v2 + d[21:24]
    bg1n, ba1n = bg1 + d[9:12], ba1 + d[12:15]
    bg2n, ba2n = bg2 + d[24:27], ba2 + d[27:30]
    dbg, dba = bg1n - pre["bg"], ba1n - pre["ba"]
    dt = pre["dt"]
    g = d.new_tensor([0.0, 0.0, -GRAVITY])
    dR = pre["dR"] @ so3_exp(_mv(pre["JRg"], dbg), plain)[0]
    R1t = R1n.transpose(-1, -2)
    r_R = so3_log(dR.transpose(-1, -2) @ R1t @ R2n)
    r_v = _mv(R1t, v2n - v1n - g * dt) - (pre["dV"] + _mv(pre["JVg"], dbg) + _mv(pre["JVa"], dba))
    r_p = (_mv(R1t, p2n - p1n - v1n * dt - 0.5 * g * dt * dt)
           - (pre["dP"] + _mv(pre["JPg"], dbg) + _mv(pre["JPa"], dba)))
    return torch.cat([r_R, r_v, r_p, bg2n - bg1n, ba2n - ba1n])


def _pair_args(P: Problem, R, p, vel, bg, ba):
    i, j = P.pair_i, P.pair_j
    return (R[i], p[i], vel[i], bg[i], ba[i], R[j], p[j], vel[j], bg[j], ba[j], P.pre)


def linearize_pairs(P: Problem, R, p, vel, bg, ba, jacobians: bool = True):
    """(r (P, 15), J (P, 15, 30) or None, cost)."""
    args = _pair_args(P, R, p, vel, bg, ba)
    zero = torch.zeros((P.pair_i.shape[0], 2 * S), dtype=R.dtype, device=R.device)
    in_dims = (0,) * 11 + ({k: 0 for k in P.pre},)
    if jacobians:
        def one(d, *a):
            return torch.func.jacfwd(lambda dd: (pair_residual(dd, *a),) * 2, has_aux=True)(d)
        J, r = torch.func.vmap(one, in_dims=in_dims)(zero, *args)
        J = J.to(r.dtype)
    else:
        r, J = torch.func.vmap(pair_residual, in_dims=in_dims)(zero, *args), None
    return r, J, (P.w_pair * r * r).sum()


class Visual(NamedTuple):
    r: torch.Tensor        # (n, 3)
    Jp: torch.Tensor       # (n, 3, 6)
    Jl: torch.Tensor       # (n, 3, 3)
    w: torch.Tensor        # (n,)
    active: torch.Tensor   # (n,) bool
    cost: torch.Tensor     # ()


def linearize_visual(P: Problem, R, p, X, cam: dict, huber: bool, arith: Arith,
                     jacobians: bool = True) -> Visual:
    # T_cw = T_cb · Twb⁻¹: R_cw = R_cb R_wbᵀ, t_cw = t_cb − R_cw p_wb
    R_cw = arith.mm("ij,kjl->kil", P.R_cb, R.transpose(-1, -2))
    t_cw = P.t_cb - arith.mm("kij,kj->ki", R_cw, p)
    Ro = R_cw[P.obs_kf]
    Xo = X[P.obs_lm]
    pc = arith.mm("nij,nj->ni", Ro, Xo) + t_cw[P.obs_kf]
    x, y, z = pc.unbind(-1)
    inv_z = 1.0 / torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
    u_hat = cam["fx"] * x * inv_z + cam["cx"]
    v_hat = cam["fy"] * y * inv_z + cam["cy"]
    stereo = P.ur >= 0
    zero = torch.zeros_like(z)
    r = torch.stack([P.uv[:, 0] - u_hat, P.uv[:, 1] - v_hat,
                     torch.where(stereo, P.ur - (u_hat - cam["bf"] * inv_z), zero)], -1)
    chi2 = (r * r).sum(-1) * P.inv_s2
    active = z > 1e-3
    if huber:
        delta = torch.where(stereo, CHI2_STEREO ** 0.5, CHI2_MONO ** 0.5).to(z.dtype)
        e = torch.sqrt(chi2.clamp_min(1e-12))
        w_rob = torch.where(e > delta, delta / e, torch.ones_like(e))
    else:
        w_rob = torch.ones_like(chi2)
    w = torch.where(active, P.inv_s2 * w_rob, zero)
    cost = torch.where(active, chi2.clamp_max(1e7) * w_rob, zero).sum()
    if not jacobians:
        return Visual(r, None, None, w, active, cost)
    iz2 = inv_z * inv_z
    row_u = torch.stack([cam["fx"] * inv_z, zero, -cam["fx"] * x * iz2], -1)
    row_v = torch.stack([zero, cam["fy"] * inv_z, -cam["fy"] * y * iz2], -1)
    row_r = (row_u + torch.stack([zero, zero, cam["bf"] * iz2], -1)) * stereo[:, None].to(z.dtype)
    Jproj = torch.stack([row_u, row_v, row_r], -2)                         # (n, 3, 3)
    JR = arith.mm("nij,njk->nik", Jproj, Ro)
    eye = torch.eye(3, dtype=z.dtype, device=z.device).expand(len(z), 3, 3)
    # r = obs − proj: ∂r/∂δ = Jproj R_cw [I | −[X]×], ∂r/∂X = −Jproj R_cw
    Jp = arith.mm("nij,njk->nik", JR, torch.cat([eye, -hat(Xo)], -1))
    return Visual(r, Jp, -JR, w, active, cost)


def _damped(H, lam, eye):
    return H + lam * torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1)) + 1e-7 * eye


def _per_side(J):
    """(P, 15, 30) → (2P, 15, 15): entry 2p + side the Jacobian in that state."""
    return J.reshape(len(J), S, 2, S).permute(0, 2, 1, 3).reshape(-1, S, S)


def solve(P: Problem, cam: dict, schedule: dict, arith: Arith, stats: dict = None):
    """The scheduled solve: returns (R, p, vel, bg, ba, X, plain cost of the
    result). ``stats``, where given, receives ``accepted`` (the steps kept)
    and ``start_cost`` (the plain cost of the map it started from)."""
    K, M = len(P.R), len(P.X)
    dt, dev = arith.dtype, P.X.device
    mm = arith.mm
    per_kf = Sums(P.obs_kf.cpu().numpy(), K, dev)
    per_lm = Sums(P.obs_lm.cpu().numpy(), M, dev)
    entries = torch.stack([P.pair_i, P.pair_j], 1).reshape(-1)
    per_state = Sums(entries.cpu().numpy(), K, dev)
    free = P.free.to(dt)
    eye15 = torch.eye(S, dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    R, p, vel, bg, ba, X = P.R, P.p, P.vel, P.bg, P.ba, P.X
    lam = torch.tensor(1e-3, dtype=dt, device=dev)
    accepted = torch.zeros((), dtype=torch.int64, device=dev)

    def pad6(a):
        return torch.nn.functional.pad(a, (0, S - 6))

    for it in range(schedule["lm_iterations"]):
        huber = it < schedule["huber_iterations"]
        L = linearize_visual(P, R, p, X, cam, huber, arith)
        r_in, J_in, cost_in = linearize_pairs(P, R, p, vel, bg, ba)
        cost = L.cost + cost_in
        Js = _per_side(J_in)                                                 # (2P, 15, 15)
        ws = P.w_pair.repeat_interleave(2, 0)
        wr = L.w[:, None] * L.r
        wr_in = (P.w_pair * r_in).repeat_interleave(2, 0)
        g_s = (pad6(per_kf(mm("nij,ni->nj", L.Jp, wr)))
               + per_state(mm("eij,ei->ej", Js, wr_in))) * free
        g_l = per_lm(mm("nij,ni->nj", L.Jl, wr))
        wJp = L.w[:, None, None] * L.Jp
        Hss = (torch.nn.functional.pad(per_kf(mm("nij,nik->njk", wJp, L.Jp).reshape(-1, 36))
                                       .reshape(K, 6, 6), (0, S - 6, 0, S - 6))
               + per_state(mm("eij,eik->ejk", ws[:, :, None] * Js, Js).reshape(-1, S * S))
               .reshape(K, S, S))
        Hll = per_lm(mm("nij,nik->njk", L.w[:, None, None] * L.Jl, L.Jl).reshape(-1, 9)
                     ).reshape(M, 3, 3)
        Minv_s = torch.linalg.inv(torch.where(free[..., None] > 0, _damped(Hss, lam, eye15),
                                              eye15))
        Minv_l = torch.linalg.inv(_damped(Hll, lam, eye3))
        lam_s = lam * torch.diagonal(Hss, dim1=-2, dim2=-1) + 1e-7
        lam_l = lam * torch.diagonal(Hll, dim1=-2, dim2=-1) + 1e-7

        def H(vs, vl):
            Jv = mm("nij,nj->ni", L.Jp, vs[P.obs_kf, :6]) + mm("nij,nj->ni", L.Jl, vl[P.obs_lm])
            wJv = L.w[:, None] * Jv
            Hv_l = per_lm(mm("nij,ni->nj", L.Jl, wJv)) + lam_l * vl
            u = P.w_pair * mm("pij,pj->pi", J_in, torch.cat([vs[P.pair_i], vs[P.pair_j]], 1))
            Hv_s = (pad6(per_kf(mm("nij,ni->nj", L.Jp, wJv)))
                    + per_state(mm("eij,ei->ej", Js, u.repeat_interleave(2, 0)))
                    + lam_s * vs) * free
            return Hv_s, Hv_l

        def prec(vs, vl):
            return mm("kij,kj->ki", Minv_s, vs) * free, mm("mij,mj->mi", Minv_l, vl)

        def dot(a, b):
            return (a[0] * b[0]).sum() + (a[1] * b[1]).sum()

        res = (-g_s, -g_l)
        x = (torch.zeros_like(g_s), torch.zeros_like(g_l))
        z = prec(*res)
        d = z
        rz = dot(res, z)
        for _ in range(schedule["cg_steps"]):
            Ad = H(*d)
            alpha = rz / dot(d, Ad).clamp_min(1e-20)
            x = (x[0] + alpha * d[0], x[1] + alpha * d[1])
            res = (res[0] - alpha * Ad[0], res[1] - alpha * Ad[1])
            z = prec(*res)
            rz_new = dot(res, z)
            beta = rz_new / rz.clamp_min(1e-20)
            d = (z[0] + beta * d[0], z[1] + beta * d[1])
            rz = rz_new
        dx, dl = x
        Rexp, Jl_so3 = so3_exp(dx[:, 3:6], arith)
        R_new = mm("kij,kjl->kil", Rexp, R)
        p_new = mm("kij,kj->ki", Rexp, p) + mm("kij,kj->ki", Jl_so3, dx[:, 0:3])
        vel_new, bg_new, ba_new = vel + dx[:, 6:9], bg + dx[:, 9:12], ba + dx[:, 12:15]
        X_new = X + dl
        L2 = linearize_visual(P, R_new, p_new, X_new, cam, huber, arith, jacobians=False)
        cost_new = L2.cost + linearize_pairs(P, R_new, p_new, vel_new, bg_new, ba_new,
                                             jacobians=False)[2]
        accept = ((cost_new < cost) & torch.isfinite(cost_new)
                  & (2 * L2.active.sum() >= L.active.sum()))
        R, p, X = (torch.where(accept, a, b) for a, b in ((R_new, R), (p_new, p), (X_new, X)))
        vel, bg, ba = (torch.where(accept, a, b)
                       for a, b in ((vel_new, vel), (bg_new, bg), (ba_new, ba)))
        lam = torch.where(accept, (lam * 0.4).clamp_min(1e-8), (lam * 5.0).clamp_max(1e4))
        accepted += accept

    def plain_cost(R, p, vel, bg, ba, X):
        return (linearize_visual(P, R, p, X, cam, False, arith, jacobians=False).cost
                + linearize_pairs(P, R, p, vel, bg, ba, jacobians=False)[2])

    cost = plain_cost(R, p, vel, bg, ba, X)
    if stats is not None:
        stats["accepted"] = int(accepted)
        stats["start_cost"] = float(plain_cost(P.R, P.p, P.vel, P.bg, P.ba, P.X))
    return R, p, vel, bg, ba, X, cost


def run(maparr: dict, config: dict, cell: dict, inv_sigma2: np.ndarray, arith: Arith, device,
        stats: dict = None) -> dict:
    """Build and solve; returns numpy float64 arrays ``R`` (K, 3, 3) and
    ``t`` (K, 3) (the cameras' Tcw), ``X``, ``vel``, ``bg``, ``ba`` and the
    plain ``cost`` as a float (``stats``: as ``solve``'s)."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        P = build_problem(maparr, config, inv_sigma2, config["max_obs"], arith, device)
        R, p, vel, bg, ba, X, cost = solve(P, config["camera"], cell["schedule"], arith, stats)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was
    R_cw = (P.R_cb @ R.transpose(-1, -2)).double()
    t_cw = P.t_cb.double() - torch.einsum("kij,kj->ki", R_cw, p.double())
    out = dict(R=R_cw, t=t_cw, X=X, vel=vel, bg=bg, ba=ba)
    out = {k: v.double().cpu().numpy() for k, v in out.items()}
    out["cost"] = float(cost)
    return out
