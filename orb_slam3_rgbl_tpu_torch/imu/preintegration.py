"""On-manifold IMU preintegration (Forster et al.; counterpart of
``orb_slam3_rgbl_tpu.imu.preintegration``; reference ``IMU::Preintegrated``,
``ImuTypes.cc``).

``preintegrate`` loops ``IntegrateNewMeasurement`` (``ImuTypes.cc:177-236``)
over the real samples in order: position and velocity with the current ΔR,
the 9×9 covariance through the A/B system matrices, the bias Jacobians
(JPa, JPg, JVa, JVg, JRg), then the rotation. The JAX package scans a window
padded to a tier with a validity mask; the port takes the real count, so a
padded sample never exists. What depends on a sample alone (its rotation
increment, right Jacobian and skew) is computed for all samples at once;
the recursion runs on the samples' device and never waits for it.
``GetDelta*`` (``ImuTypes.cc:283-308``) apply the first-order bias
corrections.

Conventions follow the reference: gravity (0, 0, −9.81) in world, the
rotation right-Jacobian for the noise propagation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from orb_slam3_rgbl_tpu_torch.device import resolve
from orb_slam3_rgbl_tpu_torch.geometry import lie

GRAVITY = 9.81


def gravity_vec(dtype, device) -> torch.Tensor:
    """(0, 0, −GRAVITY), made on ``device`` without a host copy."""
    z = torch.zeros(2, dtype=dtype, device=device)
    return torch.cat([z, torch.full((1,), -GRAVITY, dtype=dtype, device=device)])


class ImuBias(NamedTuple):
    bg: torch.Tensor  # (3,) gyro bias
    ba: torch.Tensor  # (3,) accel bias

    @staticmethod
    def zero(dtype=torch.float32, device=None) -> "ImuBias":
        """The zero bias on ``device`` (default ``cuda``)."""
        dev = resolve(device)
        return ImuBias(torch.zeros(3, dtype=dtype, device=dev),
                       torch.zeros(3, dtype=dtype, device=dev))


class Preintegrated(NamedTuple):
    """Accumulated deltas between two frames or keyframes at the
    linearization bias ``bias0`` (the reference's ``Preintegrated``)."""

    dt: torch.Tensor    # () total time
    dR: torch.Tensor    # (4,) quaternion ΔR
    dV: torch.Tensor    # (3,)
    dP: torch.Tensor    # (3,)
    JRg: torch.Tensor   # (3, 3) ∂ΔR/∂bg
    JVg: torch.Tensor   # (3, 3)
    JVa: torch.Tensor   # (3, 3)
    JPg: torch.Tensor   # (3, 3)
    JPa: torch.Tensor   # (3, 3)
    cov: torch.Tensor   # (9, 9) [θ, v, p] noise covariance
    bias0: ImuBias      # linearization point


def identity(bias: ImuBias) -> Preintegrated:
    """The preintegration of no sample at ``bias``."""
    z3 = torch.zeros((3, 3), dtype=bias.bg.dtype, device=bias.bg.device)
    z = torch.zeros(3, dtype=bias.bg.dtype, device=bias.bg.device)
    return Preintegrated(dt=z[0], dR=lie.quat_identity(z.dtype, z.device), dV=z, dP=z, JRg=z3,
                         JVg=z3, JVa=z3, JPg=z3, JPa=z3, cov=torch.zeros((9, 9), dtype=z.dtype,
                                                                       device=z.device),
                         bias0=bias)


def preintegrate(acc: torch.Tensor, gyro: torch.Tensor, dts: torch.Tensor, bias: ImuBias,
                 noise_acc: float = 2e-3, noise_gyro: float = 1.7e-4,
                 start: Preintegrated = None) -> Preintegrated:
    """Integrate ``S`` samples: ``acc`` and ``gyro`` (S, 3), ``dts`` (S,) the
    per-sample integration intervals, all on one device. Equivalent to the
    reference looping ``IntegrateNewMeasurement`` over the samples. ``start``
    (a result of this function at the same ``bias``) continues an earlier
    integration with more samples: the same operations in the same order as
    integrating all of them at once."""
    dtype, dev = acc.dtype, acc.device
    bg0, ba0 = bias.bg.to(dtype), bias.ba.to(dtype)
    if start is None:
        start = identity(ImuBias(bg0, ba0))
    S = acc.shape[0]
    nga = torch.cat([torch.full((3,), noise_gyro ** 2, dtype=dtype, device=dev),
                     torch.full((3,), noise_acc ** 2, dtype=dtype, device=dev)])
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    z3 = torch.zeros((3, 3), dtype=dtype, device=dev)

    # what depends on one sample alone, for all samples at once
    a_all = acc - ba0
    wdt = (gyro - bg0) * dts[:, None]
    dRi_all = lie.so3_exp(wdt)                          # (S, 4)
    Ri_all = lie.quat_to_matrix(dRi_all)                # (S, 3, 3)
    Jr_all = lie.so3_right_jacobian(wdt)                # (S, 3, 3)
    ah_all = lie.so3_hat(a_all)                         # (S, 3, 3)
    dt_all = dts[:, None, None]
    # the parts of A and B that do not depend on the running ΔR
    eye3s = eye3.expand(S, 3, 3)
    z3s = z3.expand(S, 3, 3)
    A0 = torch.cat([torch.cat([Ri_all.transpose(-1, -2), z3s, z3s], -1),
                    torch.cat([z3s, eye3s, z3s], -1),
                    torch.cat([z3s, eye3s * dt_all, eye3s], -1)], -2)          # (S, 9, 9)
    B0 = F.pad(Jr_all * dt_all, (0, 3, 0, 6))                                  # (S, 9, 6)

    dt_sum, dR, dV, dP, JRg, JVg, JVa, JPg, JPa, cov, _ = start
    for k in range(S):
        dt, a = dts[k], a_all[k]
        R = lie.quat_to_matrix(dR)
        Ra = R @ a
        # position and velocity with the current rotation (the reference's order)
        dP = dP + dV * dt + 0.5 * Ra * dt * dt
        dV = dV + Ra * dt
        # covariance propagation, x = [θ, v, p]
        Rah = R @ ah_all[k]
        A = A0[k] + F.pad(torch.cat([-Rah * dt, -0.5 * Rah * dt * dt]), (0, 6, 3, 0))
        B = B0[k] + F.pad(torch.cat([R * dt, 0.5 * R * dt * dt]), (3, 0, 3, 0))
        cov = A @ cov @ A.T + (B * nga) @ B.T
        # bias Jacobians (ImuTypes.cc:214-219)
        JPa = JPa + JVa * dt - 0.5 * R * dt * dt
        RahJ = Rah @ JRg
        JPg = JPg + JVg * dt - 0.5 * RahJ * dt * dt
        JVa = JVa - R * dt
        JVg = JVg - RahJ * dt
        JRg = Ri_all[k].T @ JRg - Jr_all[k] * dt
        dR = lie.quat_normalize(lie.quat_mul(dR, dRi_all[k]))
        dt_sum = dt_sum + dt
    return Preintegrated(dt=dt_sum, dR=dR, dV=dV, dP=dP, JRg=JRg, JVg=JVg, JVa=JVa,
                         JPg=JPg, JPa=JPa, cov=cov, bias0=ImuBias(bg0, ba0))


def merge(p1: Preintegrated, p2: Preintegrated) -> Preintegrated:
    """Compose consecutive segments A→B (``p1``) and B→C (``p2``) into A→C,
    the keyframe-culling relink of the temporal IMU chain (reference
    ``Preintegrated::MergePrevious``, which re-integrates the stored
    samples; here the composition is analytic: exact for the deltas,
    first-order for the bias Jacobians and the covariance). ``p2`` is first
    re-linearized at ``p1.bias0`` through its bias Jacobians."""
    b = p1.bias0
    dR2 = delta_rotation(p2, b)
    dV2 = delta_velocity(p2, b)
    dP2 = delta_position(p2, b)
    R1 = lie.quat_to_matrix(p1.dR)
    R2 = lie.quat_to_matrix(dR2)
    dt2 = p2.dt

    dR = lie.quat_normalize(lie.quat_mul(p1.dR, dR2))
    dV = p1.dV + R1 @ dV2
    dP = p1.dP + p1.dV * dt2 + R1 @ dP2

    # bias Jacobians of the composition (chain rule through R1(bg))
    hV2 = lie.so3_hat(dV2)
    hP2 = lie.so3_hat(dP2)
    JRg = R2.T @ p1.JRg + p2.JRg
    JVg = p1.JVg - R1 @ hV2 @ p1.JRg + R1 @ p2.JVg
    JVa = p1.JVa + R1 @ p2.JVa
    JPg = p1.JPg + p1.JVg * dt2 - R1 @ hP2 @ p1.JRg + R1 @ p2.JPg
    JPa = p1.JPa + p1.JVa * dt2 + R1 @ p2.JPa

    # covariance: segment 1's errors through segment 2, plus segment 2's
    eye3 = torch.eye(3, dtype=p1.cov.dtype, device=p1.cov.device)
    z3 = torch.zeros_like(eye3)
    Fm = torch.cat([torch.cat([R2.T, z3, z3], -1),
                    torch.cat([-R1 @ hV2, eye3, z3], -1),
                    torch.cat([-R1 @ hP2, eye3 * dt2, eye3], -1)], -2)
    G = torch.block_diag(eye3, R1, R1)
    cov = Fm @ p1.cov @ Fm.T + G @ p2.cov @ G.T
    return Preintegrated(dt=p1.dt + dt2, dR=dR, dV=dV, dP=dP, JRg=JRg, JVg=JVg, JVa=JVa,
                         JPg=JPg, JPa=JPa, cov=cov, bias0=b)


def _matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v[..., None])[..., 0]


def delta_rotation(p: Preintegrated, bias: ImuBias) -> torch.Tensor:
    """ΔR at a new gyro bias (``GetDeltaRotation``): dR · exp(JRg · δbg)."""
    dbg = bias.bg - p.bias0.bg
    return lie.quat_mul(p.dR, lie.so3_exp(_matvec(p.JRg, dbg)))


def delta_velocity(p: Preintegrated, bias: ImuBias) -> torch.Tensor:
    dbg = bias.bg - p.bias0.bg
    dba = bias.ba - p.bias0.ba
    return p.dV + _matvec(p.JVg, dbg) + _matvec(p.JVa, dba)


def delta_position(p: Preintegrated, bias: ImuBias) -> torch.Tensor:
    dbg = bias.bg - p.bias0.bg
    dba = bias.ba - p.bias0.ba
    return p.dP + _matvec(p.JPg, dbg) + _matvec(p.JPa, dba)


def predict_state(Rwb: torch.Tensor, vw: torch.Tensor, pw: torch.Tensor, p: Preintegrated,
                  bias: ImuBias, g: torch.Tensor = None):
    """(R, v, p) propagated through the preintegrated window
    (``Tracking::PredictStateIMU``); ``g`` the gravity vector (default
    ``gravity_vec()``)."""
    g = gravity_vec(p.dP.dtype, p.dP.device) if g is None else g
    dt = p.dt
    R1 = lie.quat_mul(Rwb, delta_rotation(p, bias))
    Rm = lie.quat_to_matrix(Rwb)
    v1 = vw + g * dt + _matvec(Rm, delta_velocity(p, bias))
    p1 = pw + vw * dt + 0.5 * g * dt * dt + _matvec(Rm, delta_position(p, bias))
    return R1, v1, p1


def inertial_residual(p: Preintegrated, Rwb1, vw1, pw1, Rwb2, vw2, pw2,
                      bias: ImuBias, g: torch.Tensor = None) -> torch.Tensor:
    """9-vector preintegration residual [r_ΔR, r_Δv, r_Δp] between two
    states (``EdgeInertial::computeError``); ``g`` the gravity vector
    (default ``gravity_vec()``)."""
    g = gravity_vec(p.dP.dtype, p.dP.device) if g is None else g
    dt = p.dt
    R1t = lie.quat_conj(Rwb1)
    er = lie.so3_log(lie.quat_mul(lie.quat_conj(delta_rotation(p, bias)),
                                  lie.quat_mul(R1t, Rwb2)))
    R1m = lie.quat_to_matrix(R1t)
    ev = _matvec(R1m, vw2 - vw1 - g * dt) - delta_velocity(p, bias)
    ep = _matvec(R1m, pw2 - pw1 - vw1 * dt - 0.5 * g * dt * dt) - delta_position(p, bias)
    return torch.cat([er, ev, ep], dim=-1)
