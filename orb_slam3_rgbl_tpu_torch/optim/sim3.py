"""Sim3 estimation: batched Horn RANSAC + Gauss-Newton refinement
(counterpart of ``orb_slam3_rgbl_tpu.optim.sim3``; reference
``Sim3Solver.cc`` and ``Optimizer::OptimizeSim3``).

All H hypotheses are evaluated at once (batched Horn on (H, 3) samples,
dense inlier counting): RANSAC with a fixed hypothesis budget instead of a
data-dependent early exit. The functions take the real correspondences;
``valid`` masks rows the caller wants ignored. Random minimal sets come
from the caller's ``torch.Generator``, or from ``draws`` when the caller
brings its own (H, 3) integers. Among hypotheses with the same inlier count
the first wins.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from orb_slam3_rgbl_tpu_torch.geometry import lie
from orb_slam3_rgbl_tpu_torch.geometry.camera import PinholeCamera


class Sim3RansacResult(NamedTuple):
    S12: torch.Tensor        # (8,) Sim3 mapping cam2-frame points → cam1 frame
    inliers: torch.Tensor    # (P,) bool
    n_inliers: torch.Tensor  # () int32


def _horn_sim3_3pt(p1: torch.Tensor, p2: torch.Tensor, fix_scale: bool) -> torch.Tensor:
    """Closed-form Sim3 from 3 correspondences (p1 ≈ S12 · p2), batched
    over leading axes. Returns (..., 8)."""
    mu1 = p1.mean(dim=-2, keepdim=True)
    mu2 = p2.mean(dim=-2, keepdim=True)
    c1 = p1 - mu1
    c2 = p2 - mu2
    C = torch.einsum("...ni,...nj->...ij", c1, c2)       # cross-covariance (3, 3)
    U, S, Vt = torch.linalg.svd(C)
    d = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
    D = torch.cat([torch.ones_like(S[..., :2]), d[..., None]], dim=-1)
    R = U @ (D[..., :, None] * Vt)
    if fix_scale:
        s = torch.ones_like(d)
    else:
        n = p2.shape[-2]
        var2 = torch.sum(c2 * c2, dim=(-2, -1))
        s = torch.sum(S * D, dim=-1) / (var2 / n).clamp_min(1e-12) / n
        s = s.clamp_min(1e-6)
    t = mu1[..., 0, :] - s[..., None] * torch.einsum("...ij,...j->...i", R, mu2[..., 0, :])
    return torch.cat([lie.matrix_to_quat(R), t, s[..., None]], dim=-1)


def _project(cam: PinholeCamera, p: torch.Tensor) -> torch.Tensor:
    z = torch.where(p[..., 2].abs() < 1e-6, 1e-6, p[..., 2])
    return torch.stack([cam.fx * p[..., 0] / z + cam.cx, cam.fy * p[..., 1] / z + cam.cy], dim=-1)


def minimal_sets(valid: torch.Tensor, n_hypotheses: int, generator: Optional[torch.Generator],
                 draws: Optional[torch.Tensor]) -> torch.Tensor:
    """(H, 3) row indices of the minimal sets: uniform draws in [0, P)
    folded onto the valid rows (valid rows first, in their order; a draw is
    taken modulo their count)."""
    P = valid.shape[0]
    if draws is None:
        if generator is None:
            raise ValueError("RANSAC needs the caller's torch.Generator (or explicit draws)")
        draws = torch.randint(0, P, (n_hypotheses, 3), generator=generator,
                              device=generator.device)
    draws = torch.as_tensor(draws).to(device=valid.device, dtype=torch.int64)
    order = torch.argsort((~valid).to(torch.int8), stable=True)
    n_valid = valid.sum().clamp_min(1)
    return order[torch.remainder(draws, n_valid)]


def first_argmax(counts: torch.Tensor) -> torch.Tensor:
    """Index of the first maximum of a vector (``argmax`` promises no
    choice among ties on the card)."""
    idx = torch.arange(counts.shape[0], device=counts.device)
    return torch.where(counts == counts.max(), idx, counts.shape[0]).min()


def sim3_hypotheses(p1_cam, p2_cam, uv1, uv2, sigma2_1, sigma2_2, valid, cam: PinholeCamera,
                    idx: torch.Tensor, fix_scale: bool):
    """Every hypothesis of the minimal sets ``idx`` (H, 3): the Sim3s
    (H, 8), their inlier masks (H, P) and inlier counts (H,). Inlier gate:
    squared reprojection error < 9.210·σ² in both images."""
    S12 = _horn_sim3_3pt(p1_cam[idx], p2_cam[idx], fix_scale)        # (H, 8)
    S21 = lie.sim3_inv(S12)
    p2_in_1 = lie.sim3_apply(S12[:, None, :], p2_cam[None])          # (H, P, 3)
    p1_in_2 = lie.sim3_apply(S21[:, None, :], p1_cam[None])
    e1 = torch.sum((_project(cam, p2_in_1) - uv1[None]) ** 2, dim=-1)
    e2 = torch.sum((_project(cam, p1_in_2) - uv2[None]) ** 2, dim=-1)
    inl = (e1 < 9.210 * sigma2_1[None]) & (e2 < 9.210 * sigma2_2[None]) & valid[None]
    return S12, inl, inl.sum(dim=1)


def sim3_ransac(p1_cam, p2_cam, uv1, uv2, sigma2_1, sigma2_2, valid, cam: PinholeCamera,
                generator: Optional[torch.Generator] = None, n_hypotheses: int = 256,
                fix_scale: bool = True,
                draws: Optional[torch.Tensor] = None) -> Sim3RansacResult:
    """Batched-hypothesis Sim3 RANSAC.

    p1_cam, p2_cam: (P, 3) matched landmark positions in each keyframe's
    camera frame; uv1, uv2: (P, 2) the keypoint measurements; sigma2_1,
    sigma2_2: (P,) pixel variances; ``fix_scale``: the depth-sensor case."""
    idx = minimal_sets(valid, n_hypotheses, generator, draws)
    S12, inl, counts = sim3_hypotheses(p1_cam, p2_cam, uv1, uv2, sigma2_1, sigma2_2, valid, cam,
                                       idx, fix_scale)
    best = first_argmax(counts)
    return Sim3RansacResult(S12=S12[best], inliers=inl[best],
                            n_inliers=counts[best].to(torch.int32))


def optimize_sim3(S12_init, p1_cam, p2_cam, uv1, uv2, inv_sigma2_1, inv_sigma2_2, valid,
                  cam: PinholeCamera, iterations: int = 10, fix_scale: bool = True):
    """Gauss-Newton refinement of S12 with reprojection residuals in both
    images (Huber at √10, outliers by chi2 > 10 as the reference). Returns
    (S12, inlier mask, inlier count). Nothing in it waits for the device."""
    delta = math.sqrt(10.0)
    dtype, dev = S12_init.dtype, S12_init.device
    # made on the device: writing a Python scalar into a tensor waits for it
    free = (torch.arange(7, device=dev) < (6 if fix_scale else 7)).to(dtype)
    eye7 = torch.eye(7, dtype=dtype, device=dev)
    tau0 = torch.zeros(7, dtype=dtype, device=dev)
    w1 = (inv_sigma2_1 * valid).repeat_interleave(2)
    w2 = (inv_sigma2_2 * valid).repeat_interleave(2)
    w_obs = torch.cat([w1, w2])

    def residuals(S12):
        S21 = lie.sim3_inv(S12)
        r1 = uv1 - _project(cam, lie.sim3_apply(S12[None], p2_cam))   # (P, 2)
        r2 = uv2 - _project(cam, lie.sim3_apply(S21[None], p1_cam))
        return r1, r2

    S12 = S12_init
    for _ in range(iterations):
        def r_of_tau(tau, S12=S12):
            S = lie.sim3_mul(lie.sim3_exp(tau * free), S12)
            r1, r2 = residuals(S)
            return torch.cat([r1.reshape(-1), r2.reshape(-1)])

        r = r_of_tau(tau0)
        J = torch.func.jacfwd(r_of_tau)(tau0)                         # (4P, 7)
        e = r.abs() * torch.sqrt(w_obs.clamp_min(1e-12))
        w = w_obs * torch.where(e > delta, delta / e.clamp_min(1e-9), 1.0)
        H = J.T @ (w[:, None] * J) + 1e-6 * eye7
        b = J.T @ (w * r)
        tau = -torch.linalg.solve_ex(H, b[:, None])[0][:, 0] * free
        S12 = lie.sim3_mul(lie.sim3_exp(tau), S12)

    r1, r2 = residuals(S12)
    chi1 = torch.sum(r1 * r1, dim=-1) * inv_sigma2_1
    chi2 = torch.sum(r2 * r2, dim=-1) * inv_sigma2_2
    inl = valid & (chi1 < 10.0) & (chi2 < 10.0)
    return S12, inl, inl.sum().to(torch.int32)
