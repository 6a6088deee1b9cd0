"""SO3 / SE3 on flat torch tensors (counterpart of
``orb_slam3_rgbl_tpu.geometry.lie``; Sim3 waits for the loop-closing slice).

* **SO3**: unit quaternion ``[w, x, y, z]`` — shape ``(..., 4)``.
* **SE3**: ``[qw, qx, qy, qz, tx, ty, tz]`` — shape ``(..., 7)``.

The se3 tangent is ``[rho(3), omega(3)]`` (translation block first).
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


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) → unit quaternion (..., 4)."""
    theta_sq = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(theta_sq + _EPS * _EPS)
    half = 0.5 * theta
    small = theta_sq < _EPS
    k = torch.where(small, 0.5 - theta_sq / 48.0, torch.sin(half) / theta)
    cw = torch.where(small, 1.0 - theta_sq / 8.0, torch.cos(half))
    return torch.cat([cw, k * w], dim=-1)


def so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian of SO3 at tangent ``w`` — (..., 3, 3)."""
    theta_sq = torch.sum(w * w, dim=-1)[..., None, None]
    theta = torch.sqrt(theta_sq + _EPS * _EPS)
    omega = so3_hat(w)
    omega2 = omega @ omega
    small = theta_sq < _EPS
    a = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / theta_sq)
    b = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (theta - torch.sin(theta)) / (theta_sq * theta))
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(omega.shape)
    return eye + a * omega + b * omega2


# ---------------------------------------------------------------------------
# SE3
# ---------------------------------------------------------------------------

def se3_identity(dtype=torch.float32, device=None) -> torch.Tensor:
    """Identity pose on ``device`` (default ``cuda``)."""
    return torch.tensor([1.0, 0, 0, 0, 0, 0, 0], dtype=dtype, device=resolve(device))


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
