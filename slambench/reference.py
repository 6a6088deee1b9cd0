"""Plain reference of the whole-map bundle adjustment that the loop closer
runs after a correction (ORB-SLAM3's ``Optimizer::GlobalBundleAdjustemnt``
as the port schedules it): Levenberg-Marquardt over every keyframe pose and
landmark, each step's normal equations solved by a fixed number of
block-Jacobi preconditioned conjugate-gradient steps, Huber weights while the
iteration counter of a chunk is below ``huber_iterations``, the damping and
the iteration counter restarting with every chunk.

Plain PyTorch over a flat list of the observations, with rotation matrices
and scatter-adds: it imports neither JAX nor anything of the program (only
numpy, torch and the benchmark's ``mapgen``) and builds its problem from the
map's raw arrays (``mapgen.generate``'s dict).
``Arith`` says how it computes: float64 for the reference; float32 with
every matrix product's operands rounded to TF32 for the control.

The semantics it follows, those of the program's solve:

* residual r = (u, v, u_R) observed − predicted, the third row only for an
  observation with a right coordinate (u_R ≥ 0); χ² = |r|² / σ²(octave);
* weight w = 1/σ² × Huber (δ² = 7.815 with u_R, 5.991 without) for an
  observation in front of its camera (z > 1e-3); cost = Σ w_rob χ² (χ²
  capped at 1e7) + 1e7 for each observation behind its camera;
* pose update T ← exp(δ) T on the left, δ = (ρ, ω), ∂p_c/∂δ = [I | −[p_c]×];
  landmark update X ← X + δX; the first keyframe fixed;
* PCG on (JᵀWJ + λ diag(JᵀWJ) + 1e-7 I) x = −JᵀWr from x = 0, the
  preconditioner the inverse of each pose's 6×6 and each landmark's 3×3
  damped block; α = rz / max(pAp, 1e-20), β = rz' / max(rz, 1e-20);
* a step is kept when its cost is lower, finite, and keeps at least half of
  the active observations; λ then × 0.4 (≥ 1e-8), else × 5 (≤ 1e4), from
  1e-3 at the start of each chunk;
* each landmark keeps at most ``max_obs`` observations: with T > D
  observers in keyframe order, observer j is kept where ⌊jD/T⌋ moves on.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slambench.mapgen import quat_to_matrix

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class Arith:
    """How the reference computes: a dtype, and whether the operands of every
    matrix product are first rounded to TF32 (10 explicit mantissa bits,
    round to nearest even), as the card's TF32 tensor cores round them."""

    def __init__(self, dtype=torch.float64, tf32: bool = False):
        self.dtype = dtype
        self.tf32 = tf32

    def mm(self, spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.tf32:
            a, b = round_tf32(a), round_tf32(b)
        return torch.einsum(spec, a, b)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa (nearest, ties to
    even), still stored as float32."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0xFFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)


class Problem(NamedTuple):
    R: torch.Tensor          # (K, 3, 3) world → camera
    t: torch.Tensor          # (K, 3)
    X: torch.Tensor          # (M, 3)
    pose_free: torch.Tensor  # (K,) bool
    obs_kf: torch.Tensor     # (n,) int64
    obs_lm: torch.Tensor     # (n,)
    uv: torch.Tensor         # (n, 2)
    ur: torch.Tensor         # (n,)
    inv_s2: torch.Tensor     # (n,)


def observations(maparr: dict, max_obs: int):
    """The kept observations of the map: (keyframe, landmark, feature) as
    numpy arrays, every valid keyframe and landmark in id order."""
    lm_idx = maparr["kf_lm_idx"]
    kf, feat = np.nonzero(lm_idx >= 0)            # keyframe-major, features ascending
    lm = lm_idx[kf, feat].astype(np.int64)
    order = np.lexsort((feat, kf, lm))            # per landmark, keyframes in order
    kf, feat, lm = kf[order], feat[order], lm[order]
    total = np.bincount(lm, minlength=len(maparr["lm_pos"]))
    first = np.cumsum(total) - total
    j = np.arange(len(lm)) - first[lm]
    T = total[lm]
    D = max_obs
    keep = (T <= D) | (j == 0) | ((j * D) // T != ((j - 1) * D) // T)
    return kf[keep], lm[keep], feat[keep]


def build_problem(maparr: dict, inv_sigma2: np.ndarray, max_obs: int, arith: Arith,
                  device) -> Problem:
    kf, lm, feat = observations(maparr, max_obs)
    R = quat_to_matrix(maparr["kf_pose"][:, :4])
    K = len(R)
    pose_free = np.ones(K, bool)
    pose_free[0] = False

    def up(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype or arith.dtype, device=device)

    return Problem(
        R=up(R), t=up(maparr["kf_pose"][:, 4:7]), X=up(maparr["lm_pos"]),
        pose_free=up(pose_free, torch.bool),
        obs_kf=up(kf, torch.int64), obs_lm=up(lm, torch.int64),
        uv=up(maparr["kf_uv"][kf, feat]), ur=up(maparr["kf_ur"][kf, feat]),
        inv_s2=up(inv_sigma2[maparr["kf_octave"][kf, feat]]))


def hat(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[..., 0])
    x, y, w = v.unbind(-1)
    return torch.stack([z, -w, y, w, z, -x, -y, x, z], -1).reshape(v.shape[:-1] + (3, 3))


def so3_exp(w: torch.Tensor, arith: Arith):
    """Rotation matrix and left Jacobian of each rotation vector."""
    th2 = (w * w).sum(-1)[..., None, None]
    th = torch.sqrt(th2)
    small = th2 < 1e-12
    safe = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(safe) / safe)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(safe)) / (safe * safe))
    c = torch.where(small, 1.0 / 6.0 - th2 / 120.0, (safe - torch.sin(safe)) / (safe ** 3))
    W = hat(w)
    W2 = arith.mm("...ij,...jk->...ik", W, W)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a * W + b * W2, eye + b * W + c * W2


class Linearization(NamedTuple):
    r: torch.Tensor        # (n, 3)
    Jp: torch.Tensor       # (n, 3, 6)
    Jl: torch.Tensor       # (n, 3, 3)
    w: torch.Tensor        # (n,)
    active: torch.Tensor   # (n,) bool
    cost: torch.Tensor     # ()


def linearize(P: Problem, R, t, X, cam: dict, huber: bool, arith: Arith,
              jacobians: bool = True) -> Linearization:
    Ro = R[P.obs_kf]
    pc = arith.mm("nij,nj->ni", Ro, X[P.obs_lm]) + t[P.obs_kf]
    x, y, z = pc.unbind(-1)
    safe_z = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
    inv_z = 1.0 / safe_z
    u_hat = cam["fx"] * x * inv_z + cam["cx"]
    v_hat = cam["fy"] * y * inv_z + cam["cy"]
    stereo = P.ur >= 0
    ur_hat = u_hat - cam["bf"] * inv_z
    zero = torch.zeros_like(z)
    r = torch.stack([P.uv[:, 0] - u_hat, P.uv[:, 1] - v_hat,
                     torch.where(stereo, P.ur - ur_hat, zero)], -1)
    chi2 = (r * r).sum(-1) * P.inv_s2
    considered = torch.ones_like(stereo)
    depth_ok = z > 1e-3
    active = considered & depth_ok
    if huber:
        delta = torch.where(stereo, CHI2_STEREO ** 0.5, CHI2_MONO ** 0.5).to(z.dtype)
        e = torch.sqrt(chi2.clamp_min(1e-12))
        w_rob = torch.where(e > delta, delta / e, torch.ones_like(e))
    else:
        w_rob = torch.ones_like(chi2)
    w = torch.where(active, P.inv_s2 * w_rob, zero)
    cost = (torch.where(active, chi2.clamp_max(1e7) * w_rob, zero).sum()
            + 1e7 * (considered & ~depth_ok).sum())
    if not jacobians:
        return Linearization(r, None, None, w, active, cost)
    # ∂(u, v, u_R)/∂p_c, the third row zero without a right coordinate
    iz2 = inv_z * inv_z
    row_u = torch.stack([cam["fx"] * inv_z, zero, -cam["fx"] * x * iz2], -1)
    row_v = torch.stack([zero, cam["fy"] * inv_z, -cam["fy"] * y * iz2], -1)
    row_r = row_u + torch.stack([zero, zero, cam["bf"] * iz2], -1)
    row_r = row_r * stereo[:, None].to(z.dtype)
    Jproj = torch.stack([row_u, row_v, row_r], -2)                      # (n, 3, 3)
    eye = torch.eye(3, dtype=z.dtype, device=z.device).expand(len(z), 3, 3)
    dpc = torch.cat([eye, -hat(pc)], -1)                                 # (n, 3, 6)
    Jp = -arith.mm("nij,njk->nik", Jproj, dpc)
    Jl = -arith.mm("nij,njk->nik", Jproj, Ro)
    return Linearization(r, Jp, Jl, w, active, cost)


def _diag_damped(H, lam, eye):
    d = torch.diagonal(H, dim1=-2, dim2=-1)
    return H + lam * torch.diag_embed(d) + 1e-7 * eye


def solve(P: Problem, cam: dict, schedule: dict, arith: Arith, stats: dict = None):
    """The scheduled solve: returns (R, t, X, plain cost of the result).
    ``stats``, where given, receives ``accepted`` (the steps kept) and
    ``start_cost`` (the plain cost of the map it started from)."""
    K, M = len(P.R), len(P.X)
    dt, dev = arith.dtype, P.X.device
    R, t, X = P.R, P.t, P.X
    pf = P.pose_free[:, None].to(dt)
    eye6 = torch.eye(6, dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    mm = arith.mm

    def per_pose(v):
        return torch.zeros((K,) + v.shape[1:], dtype=dt, device=dev).index_add_(0, P.obs_kf, v)

    def per_lm(v):
        return torch.zeros((M,) + v.shape[1:], dtype=dt, device=dev).index_add_(0, P.obs_lm, v)

    total, chunk = schedule["lm_iterations"], schedule["chunk"]
    done, accepted = 0, torch.zeros((), dtype=torch.int64, device=dev)
    while done < total:
        n_it = min(chunk, total - done)
        lam = torch.tensor(1e-3, dtype=dt, device=dev)
        for it in range(n_it):
            huber = it < schedule["huber_iterations"]
            L = linearize(P, R, t, X, cam, huber, arith)
            wr = L.w[:, None] * L.r
            g_p = per_pose(mm("nij,ni->nj", L.Jp, wr)) * pf
            g_l = per_lm(mm("nij,ni->nj", L.Jl, wr))
            wJp = L.w[:, None, None] * L.Jp
            wJl = L.w[:, None, None] * L.Jl
            Hpp = per_pose(mm("nij,nik->njk", wJp, L.Jp))
            Hll = per_lm(mm("nij,nik->njk", wJl, L.Jl))
            Minv_p = torch.linalg.inv(torch.where(pf[..., None] > 0, _diag_damped(Hpp, lam, eye6),
                                                  eye6))
            Minv_l = torch.linalg.inv(_diag_damped(Hll, lam, eye3))
            lam_p = lam * torch.diagonal(Hpp, dim1=-2, dim2=-1) + 1e-7
            lam_l = lam * torch.diagonal(Hll, dim1=-2, dim2=-1) + 1e-7

            def H(vp, vl):
                Jv = (mm("nij,nj->ni", L.Jp, vp[P.obs_kf]) + mm("nij,nj->ni", L.Jl, vl[P.obs_lm]))
                wJv = L.w[:, None] * Jv
                Hv_l = per_lm(mm("nij,ni->nj", L.Jl, wJv)) + lam_l * vl
                Hv_p = (per_pose(mm("nij,ni->nj", L.Jp, wJv)) + lam_p * vp) * pf
                return Hv_p, Hv_l

            def prec(vp, vl):
                return mm("kij,kj->ki", Minv_p, vp) * pf, mm("mij,mj->mi", Minv_l, vl)

            def dot(a, b):
                return (a[0] * b[0]).sum() + (a[1] * b[1]).sum()

            res = (-g_p, -g_l)
            x = (torch.zeros_like(g_p), torch.zeros_like(g_l))
            z = prec(*res)
            p = z
            rz = dot(res, z)
            for _ in range(schedule["cg_steps"]):
                Ap = H(*p)
                alpha = rz / dot(p, Ap).clamp_min(1e-20)
                x = (x[0] + alpha * p[0], x[1] + alpha * p[1])
                res = (res[0] - alpha * Ap[0], res[1] - alpha * Ap[1])
                z = prec(*res)
                rz_new = dot(res, z)
                beta = rz_new / rz.clamp_min(1e-20)
                p = (z[0] + beta * p[0], z[1] + beta * p[1])
                rz = rz_new
            dp, dl = x
            Rexp, Jl_so3 = so3_exp(dp[:, 3:], arith)
            R_new = mm("kij,kjl->kil", Rexp, R)
            t_new = mm("kij,kj->ki", Rexp, t) + mm("kij,kj->ki", Jl_so3, dp[:, :3])
            X_new = X + dl
            L2 = linearize(P, R_new, t_new, X_new, cam, huber, arith, jacobians=False)
            accept = ((L2.cost < L.cost) & torch.isfinite(L2.cost)
                      & (2 * L2.active.sum() >= L.active.sum()))
            R = torch.where(accept, R_new, R)
            t = torch.where(accept, t_new, t)
            X = torch.where(accept, X_new, X)
            lam = torch.where(accept, (lam * 0.4).clamp_min(1e-8), (lam * 5.0).clamp_max(1e4))
            accepted += accept
        done += n_it
    cost = linearize(P, R, t, X, cam, False, arith, jacobians=False).cost
    if stats is not None:
        stats["accepted"] = int(accepted)
        stats["start_cost"] = float(linearize(P, P.R, P.t, P.X, cam, False, arith,
                                              jacobians=False).cost)
    return R, t, X, cost


def run(maparr: dict, inv_sigma2: np.ndarray, cam: dict, max_obs: int, schedule: dict,
        arith: Arith, device, stats: dict = None):
    """Build and solve; returns numpy (R (K,3,3), t (K,3), X (M,3)) in
    float64 and the cost as a float (``stats``: as ``solve``'s)."""
    P = build_problem(maparr, inv_sigma2, max_obs, arith, device)
    R, t, X, cost = solve(P, cam, schedule, arith, stats)
    return (R.double().cpu().numpy(), t.double().cpu().numpy(), X.double().cpu().numpy(),
            float(cost))
