"""SO3 / SE3 / Sim3 on flat torch tensors (counterpart of
``orb_slam3_rgbl_tpu.geometry.lie``).

* **SO3**: unit quaternion ``[w, x, y, z]`` — shape ``(..., 4)``.
* **SE3**: ``[qw, qx, qy, qz, tx, ty, tz]`` — shape ``(..., 7)``.
* **Sim3**: ``[qw, qx, qy, qz, tx, ty, tz, s]`` — shape ``(..., 8)``,
  acting as ``x ↦ s·R·x + t``.

The se3 tangent is ``[rho(3), omega(3)]`` (translation block first); the
sim3 tangent appends the log-scale ``sigma``.
Exp maps use Taylor guards near the identity. The ``np_*`` twins serve
the per-frame host loop (single (7,) poses), as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from orb_slam3_rgbl_tpu_torch.device import resolve

_EPS = 1e-8


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


# ---------------------------------------------------------------------------
# quaternion core
# ---------------------------------------------------------------------------

def quat_identity(dtype=torch.float32, device=None) -> torch.Tensor:
    """Identity quaternion on ``device`` (default ``cuda``), made there: a
    tensor from a Python list is a host copy that waits for the card."""
    dev = resolve(device)
    return torch.cat([torch.ones(1, dtype=dtype, device=dev),
                      torch.zeros(3, dtype=dtype, device=dev)])


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b (both ``[w,x,y,z]``)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) ``v`` (..., 3) by quaternion(s) ``q`` (..., 4)."""
    w = q[..., :1]
    xyz = q[..., 1:]
    t = 2.0 * _cross(xyz, v)
    return v + w * t + _cross(xyz, t)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) unit quaternion → (..., 3, 3) rotation matrix."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation matrix → (..., 4) unit quaternion (w ≥ 0),
    branch-free Shepperd's method: the candidate with the largest pivot."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    pivots = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22,
                          1.0 - m00 - m11 + m22], dim=-1)
    best = torch.argmax(pivots, dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)            # (..., 4 candidates, 4)
    q = torch.take_along_dim(cands, best[..., None, None], dim=-2).squeeze(-2)
    q = quat_normalize(q)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


# ---------------------------------------------------------------------------
# SO3
# ---------------------------------------------------------------------------

def so3_hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) → (..., 3, 3) skew-symmetric matrix."""
    zeros = torch.zeros_like(w[..., 0])
    wx, wy, wz = w.unbind(-1)
    m = torch.stack([zeros, -wz, wy, wz, zeros, -wx, -wy, wx, zeros], dim=-1)
    return m.reshape(w.shape[:-1] + (3, 3))


def so3_vee(m: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) skew-symmetric matrix → (..., 3), the inverse of ``so3_hat``."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) → unit quaternion (..., 4)."""
    theta_sq = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(theta_sq + _EPS * _EPS)
    half = 0.5 * theta
    small = theta_sq < _EPS
    k = torch.where(small, 0.5 - theta_sq / 48.0, torch.sin(half) / theta)
    cw = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(half))
    return torch.cat([cw, k * w], dim=-1)


def so3_log(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) → axis-angle (..., 3)."""
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)   # w >= 0 ⇒ theta in [0, pi]
    w = q[..., :1].clamp(-1.0, 1.0)
    xyz = q[..., 1:]
    n_sq = torch.sum(xyz * xyz, dim=-1, keepdim=True)
    n = torch.sqrt(n_sq + _EPS * _EPS)
    theta = 2.0 * torch.atan2(n, w)
    small = n_sq < _EPS
    k = torch.where(small, 2.0 / w.clamp_min(0.5) + 2.0 * n_sq / 3.0, theta / n)
    return k * xyz


def so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian of SO3 at tangent ``w`` — (..., 3, 3)."""
    theta_sq = torch.sum(w * w, dim=-1)[..., None, None]
    theta = torch.sqrt(theta_sq + _EPS * _EPS)
    omega = so3_hat(w)
    omega2 = omega @ omega
    small = theta_sq < _EPS
    # both branches finite (a safe denominator): forward-mode derivatives
    # pass through the branch torch.where drops
    safe_sq = torch.where(small, 1.0, theta_sq)
    a = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / safe_sq)
    b = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (theta - torch.sin(theta)) / (safe_sq * theta))
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(omega.shape)
    return eye + a * omega + b * omega2


def so3_right_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Right Jacobian of SO3 at tangent ``w``: J_r(w) = J_l(−w)."""
    return so3_left_jacobian(-w)


def so3_inv_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Inverse left Jacobian of SO3 at tangent ``w`` — (..., 3, 3):
    I − Ω/2 + c Ω² with c = 1/θ² − (1 + cos θ) / (2 θ sin θ)."""
    theta_sq = torch.sum(w * w, dim=-1)[..., None, None]
    theta = torch.sqrt(theta_sq + _EPS * _EPS)
    omega = so3_hat(w)
    small = theta_sq < _EPS
    safe_sq = torch.where(small, 1.0, theta_sq)
    safe = torch.where(small, 1.0, theta)
    c = torch.where(small, 1.0 / 12.0 + theta_sq / 720.0,
                    1.0 / safe_sq - (1.0 + torch.cos(safe)) / (2.0 * safe * torch.sin(safe)))
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(omega.shape)
    return eye - 0.5 * omega + c * (omega @ omega)


# ---------------------------------------------------------------------------
# SE3
# ---------------------------------------------------------------------------

def se3_identity(dtype=torch.float32, device=None) -> torch.Tensor:
    """Identity pose on ``device`` (default ``cuda``)."""
    return torch.tensor([1.0, 0, 0, 0, 0, 0, 0], dtype=dtype, device=resolve(device))


def se3(q: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) and translation (..., 3) → SE3 (..., 7)."""
    return torch.cat([q, t], dim=-1)


def se3_rot(T: torch.Tensor) -> torch.Tensor:
    return T[..., :4]


def se3_trans(T: torch.Tensor) -> torch.Tensor:
    return T[..., 4:7]


def se3_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    q = quat_mul(a[..., :4], b[..., :4])
    t = quat_rotate(a[..., :4], b[..., 4:7]) + a[..., 4:7]
    return torch.cat([q, t], dim=-1)


def se3_inv(T: torch.Tensor) -> torch.Tensor:
    qi = quat_conj(T[..., :4])
    return torch.cat([qi, -quat_rotate(qi, T[..., 4:7])], dim=-1)


def se3_apply(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 7) SE3 to (..., 3) points (broadcasting)."""
    return quat_rotate(T[..., :4], pts) + T[..., 4:7]


def se3_exp(tau: torch.Tensor) -> torch.Tensor:
    """Tangent ``[rho, omega]`` (..., 6) → SE3 (..., 7)."""
    rho, w = tau[..., :3], tau[..., 3:]
    q = so3_exp(w)
    t = torch.einsum("...ij,...j->...i", so3_left_jacobian(w), rho)
    return torch.cat([q, t], dim=-1)


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """SE3 (..., 7) → tangent ``[rho, omega]`` (..., 6), the inverse of
    ``se3_exp``."""
    w = so3_log(T[..., :4])
    rho = torch.einsum("...ij,...j->...i", so3_inv_left_jacobian(w), T[..., 4:7])
    return torch.cat([rho, w], dim=-1)


def se3_to_matrix(T: torch.Tensor) -> torch.Tensor:
    """(..., 7) → (..., 4, 4) homogeneous matrix."""
    top = torch.cat([quat_to_matrix(T[..., :4]), T[..., 4:7, None]], dim=-1)
    bottom = torch.zeros(T.shape[:-1] + (1, 4), dtype=T.dtype, device=T.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def se3_from_matrix(M: torch.Tensor) -> torch.Tensor:
    return torch.cat([matrix_to_quat(M[..., :3, :3]), M[..., :3, 3]], dim=-1)


def se3_normalize(T: torch.Tensor) -> torch.Tensor:
    return torch.cat([quat_normalize(T[..., :4]), T[..., 4:7]], dim=-1)


# ---------------------------------------------------------------------------
# Sim3
# ---------------------------------------------------------------------------

def sim3_identity(dtype=torch.float32, device=None) -> torch.Tensor:
    """Identity similarity on ``device`` (default ``cuda``)."""
    return torch.tensor([1.0, 0, 0, 0, 0, 0, 0, 1.0], dtype=dtype, device=resolve(device))


def sim3(q: torch.Tensor, t: torch.Tensor, s) -> torch.Tensor:
    s = torch.as_tensor(s, dtype=t.dtype, device=t.device).expand(t.shape[:-1])
    return torch.cat([q, t, s[..., None]], dim=-1)


def sim3_parts(S: torch.Tensor):
    return S[..., :4], S[..., 4:7], S[..., 7]


def sim3_from_se3(T: torch.Tensor) -> torch.Tensor:
    return torch.cat([T, torch.ones_like(T[..., :1])], dim=-1)


def sim3_to_se3(S: torch.Tensor) -> torch.Tensor:
    """Drop the scale: the translation is divided by it, as the reference's
    ``CorrectLoop`` does when it writes a Sim3 correction into SE3 poses."""
    q, t, s = sim3_parts(S)
    return torch.cat([q, t / s[..., None]], dim=-1)


def sim3_apply(S: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    q, t, s = sim3_parts(S)
    return s[..., None] * quat_rotate(q, pts) + t


def sim3_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    qa, ta, sa = sim3_parts(a)
    qb, tb, sb = sim3_parts(b)
    q = quat_mul(qa, qb)
    t = sa[..., None] * quat_rotate(qa, tb) + ta
    return torch.cat([q, t, (sa * sb)[..., None]], dim=-1)


def sim3_inv(S: torch.Tensor) -> torch.Tensor:
    q, t, s = S[..., :4], S[..., 4:7], S[..., 7:8]
    qi = quat_conj(q)
    si = 1.0 / s
    return torch.cat([qi, -si * quat_rotate(qi, t), si], dim=-1)


def _sim3_W(w: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """The Sim3 'W' matrix with t = W @ rho (Eade's notes, §5.3):
    W = A I + B Ω + C Ω², coefficients in (θ, σ) with their σ→0 and θ→0
    limits. ``sigma`` has shape (..., 1): under ``torch.func`` transforms a
    0-dim operand beside a Python scalar comes out as f64."""
    theta_sq = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(theta_sq + _EPS * _EPS)
    s = torch.exp(sigma)
    omega = so3_hat(w)
    omega2 = omega @ omega

    small_sigma = sigma.abs() < 1e-5
    small_theta = theta_sq < _EPS
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    sig_sq = sigma * sigma
    denom = sig_sq + theta_sq

    safe_sigma = sigma.masked_fill(small_sigma, 1.0)
    safe_theta_sq = theta_sq.masked_fill(small_theta, 1.0)
    safe_denom = denom.masked_fill(denom < 1e-12, 1.0)

    A = torch.where(small_sigma, 1.0 + sigma / 2.0 + sig_sq / 6.0, (s - 1.0) / safe_sigma)
    a_ = s * sin_t
    b_ = s * cos_t
    B_gen = ((sigma * a_ / theta) + (1.0 - b_)) / safe_denom
    B_theta0 = torch.where(small_sigma, 0.5 + sigma / 3.0,
                           (s * (safe_sigma - 1.0) + 1.0) / sig_sq.masked_fill(small_sigma, 1.0))
    B = torch.where(small_theta, B_theta0, B_gen)

    C_gen = (A - ((b_ - 1.0) * sigma + a_ * theta) / safe_denom) / safe_theta_sq
    C_sigma = ((s * (safe_sigma * safe_sigma / 2.0 - safe_sigma + 1.0) - 1.0)
               / (safe_sigma * safe_sigma * safe_sigma))
    C_theta0 = torch.where(small_sigma, 1.0 / 6.0 + sigma / 8.0, C_sigma)
    C = torch.where(small_theta, C_theta0, C_gen)

    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(omega.shape)
    return A[..., None] * eye + B[..., None] * omega + C[..., None] * omega2


def _solve3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with A x = b for (..., 3, 3) systems, by the adjugate (rows' cross
    products): elementary operations only, so that it differentiates and
    batches under ``torch.func`` (a batched ``linalg.solve_ex`` inside
    ``vmap(jacfwd(...))`` returned non-finite tangents)."""
    r0, r1, r2 = A[..., 0, :], A[..., 1, :], A[..., 2, :]
    c0, c1, c2 = _cross(r1, r2), _cross(r2, r0), _cross(r0, r1)     # columns of adj(A)
    det = torch.sum(r0 * c0, dim=-1, keepdim=True)
    return (c0 * b[..., 0:1] + c1 * b[..., 1:2] + c2 * b[..., 2:3]) / det


def sim3_exp(tau: torch.Tensor) -> torch.Tensor:
    """Tangent ``[rho(3), omega(3), sigma]`` (..., 7) → Sim3 (..., 8)."""
    rho, w, sigma = tau[..., :3], tau[..., 3:6], tau[..., 6:7]
    t = torch.einsum("...ij,...j->...i", _sim3_W(w, sigma), rho)
    return torch.cat([so3_exp(w), t, torch.exp(sigma)], dim=-1)


def sim3_log(S: torch.Tensor) -> torch.Tensor:
    w = so3_log(S[..., :4])
    sigma = torch.log(S[..., 7:8])
    rho = _solve3(_sim3_W(w, sigma), S[..., 4:7])
    return torch.cat([rho, w, sigma], dim=-1)


# ---------------------------------------------------------------------------
# numpy twins (host control path)
# ---------------------------------------------------------------------------

def np_se3_identity() -> np.ndarray:
    return np.array([1.0, 0, 0, 0, 0, 0, 0], np.float32)


def np_quat_mul(q1, q2):
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return np.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], axis=-1)


def np_quat_rotate(q, v):
    w = q[..., :1]
    u = q[..., 1:]
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


def np_se3_mul(T1, T2):
    q = np_quat_mul(T1[..., :4], T2[..., :4])
    t = np_quat_rotate(T1[..., :4], T2[..., 4:7]) + T1[..., 4:7]
    return np.concatenate([q, t], axis=-1).astype(np.float32)


def np_se3_inv(T):
    q = T[..., :4] * np.asarray([1.0, -1.0, -1.0, -1.0], np.float32)
    t = -np_quat_rotate(q, T[..., 4:7])
    return np.concatenate([q, t], axis=-1).astype(np.float32)


def np_se3_centers(Tcw):
    """Camera centers Ow = −Rᵀt for (..., 7) Tcw arrays."""
    q = Tcw[..., :4] * np.asarray([1.0, -1.0, -1.0, -1.0], np.float32)
    return (-np_quat_rotate(q, Tcw[..., 4:7])).astype(np.float32)


def np_se3_apply(T, X):
    """Numpy SE3 point transform for (..., 7) ∘ (..., 3)."""
    return (np_quat_rotate(T[..., :4], X) + T[..., 4:7]).astype(np.float32)


def np_sim3_mul(S1, S2):
    """Numpy Sim3 composition for (..., 8) ``[q, t, s]``: the loop
    closer's host math runs on arrays of varying length."""
    q = np_quat_mul(S1[..., :4], S2[..., :4])
    t = S1[..., 7:8] * np_quat_rotate(S1[..., :4], S2[..., 4:7]) + S1[..., 4:7]
    s = S1[..., 7:8] * S2[..., 7:8]
    return np.concatenate([q, t, s], axis=-1).astype(np.float32)


def np_sim3_inv(S):
    qi = S[..., :4] * np.asarray([1.0, -1.0, -1.0, -1.0], np.float32)
    si = 1.0 / S[..., 7:8]
    t = -si * np_quat_rotate(qi, S[..., 4:7])
    return np.concatenate([qi, t, si], axis=-1).astype(np.float32)


def np_sim3_apply(S, X):
    """(..., 8) ∘ (..., 3): X' = s·R·X + t."""
    return (S[..., 7:8] * np_quat_rotate(S[..., :4], X) + S[..., 4:7]).astype(np.float32)


def np_sim3_from_se3(T):
    ones = np.ones(T.shape[:-1] + (1,), np.float32)
    return np.concatenate([np.asarray(T, np.float32), ones], axis=-1)


def np_sim3_to_se3(S):
    """Sim3 → SE3 with the translation divided by the scale: Tcw = [R | t/s]."""
    t = S[..., 4:7] / S[..., 7:8]
    return np.concatenate([S[..., :4], t], axis=-1).astype(np.float32)
