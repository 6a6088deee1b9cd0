"""Synthetic textured RGB-L world (counterpart of
``orb_slam3_rgbl_tpu.synthetic``): multi-view-consistent image and LiDAR
rendering with exact ground-truth poses, so the port's tracking loop runs
on real images without a dataset.

A piecewise-planar street canyon (ground + two walls + far wall), or a
closed square room for drives that revisit their own view, with
procedural textures drawn from ``numpy.random.default_rng(seed)`` (the
JAX package draws them with ``jax.random``, so the two worlds share their
geometry but not their textures). Camera x right / y down / z forward;
velodyne x forward / y left / z up; ``T_VELO_CAM`` is the axis swap.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from orb_slam3_rgbl_tpu_torch.device import resolve
from orb_slam3_rgbl_tpu_torch.geometry import lie

# KITTI-style velodyne→camera axis swap, small lever arm.
T_VELO_CAM = np.array(
    [[0.0, -1.0, 0.0, 0.0],
     [0.0, 0.0, -1.0, -0.08],
     [1.0, 0.0, 0.0, 0.27]], np.float32
)


class World(NamedTuple):
    """Planes n·X = b with texture bases (e1, e2) and texture images."""

    normals: torch.Tensor    # (P, 3)
    offsets: torch.Tensor    # (P,)
    e1: torch.Tensor         # (P, 3) texture u basis
    e2: torch.Tensor         # (P, 3)
    tex: torch.Tensor        # (P, T, T) f32 10..245
    tex_scale: torch.Tensor  # (P,) texels per meter


def _textures(rng: np.random.Generator, n: int, tex_size: int) -> np.ndarray:
    texs = []
    for _ in range(n):
        t = rng.uniform(size=(tex_size, tex_size)).astype(np.float32)
        # band-limit: 2 passes of a 5×5 wrap-around box blur
        for _ in range(2):
            t = sum(np.roll(t, r, axis=0) for r in range(-2, 3)) / 5.0
            t = sum(np.roll(t, r, axis=1) for r in range(-2, 3)) / 5.0
        t = t - t.min()
        texs.append(t / max(t.max(), 1e-6) * 235.0 + 10.0)
    return np.stack(texs).astype(np.float32)


def make_world(seed: int = 0, tex_size: int = 512, half_width: float = 8.0,
               ground_y: float = 1.6, far_z: float = 120.0, device=None) -> World:
    """Street canyon: ground plane, left/right walls, far wall."""
    dev = resolve(device)

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    return World(
        normals=t([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]),
        offsets=t([ground_y, -half_width, half_width, far_z]),
        e1=t([[1, 0, 0], [0, 0, 1], [0, 0, 1], [1, 0, 0]]),
        e2=t([[0, 0, 1], [0, 1, 0], [0, 1, 0], [0, 1, 0]]),
        tex=torch.from_numpy(_textures(np.random.default_rng(seed), 4, tex_size)).to(dev),
        tex_scale=t([3.0, 3.0, 3.0, 3.0]),
    )


def make_box_world(seed: int = 0, tex_size: int = 512, half: float = 14.0,
                   ground_y: float = 1.6, device=None) -> World:
    """Closed square room (4 inward-facing walls + ground): a circular
    trajectory inside revisits its own view, the image-level loop-closure
    scene the straight canyon cannot produce."""
    dev = resolve(device)

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    return World(
        normals=t([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0],
                   [0.0, 0.0, 1.0]]),
        offsets=t([ground_y, -half, half, -half, half]),
        e1=t([[1, 0, 0], [0, 0, 1], [0, 0, 1], [1, 0, 0], [1, 0, 0]]),
        e2=t([[0, 0, 1], [0, 1, 0], [0, 1, 0], [0, 1, 0], [0, 1, 0]]),
        tex=torch.from_numpy(_textures(np.random.default_rng(seed), 5, tex_size)).to(dev),
        tex_scale=t([3.0] * 5),
    )


def _sample_tex(tex: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bilinear wrap-around sample of (T, T) at float (u, v)."""
    T = tex.shape[0]
    u0, v0 = torch.floor(u), torch.floor(v)
    fu, fv = u - u0, v - v0
    i0 = torch.remainder(u0.long(), T)
    i1 = torch.remainder(i0 + 1, T)
    j0 = torch.remainder(v0.long(), T)
    j1 = torch.remainder(j0 + 1, T)
    a = tex[j0, i0] * (1 - fu) + tex[j0, i1] * fu
    b = tex[j1, i0] * (1 - fu) + tex[j1, i1] * fu
    return a * (1 - fv) + b * fv


def _cast(world: World, origins: torch.Tensor, dirs: torch.Tensor):
    """Ray-cast (..., 3) origins/dirs against all planes → (t, plane, hit)
    of the nearest positive intersection."""
    n = world.normals
    denom = torch.einsum("pk,...k->...p", n, dirs)
    num = world.offsets - torch.einsum("pk,...k->...p", n, origins)
    t = num / torch.where(denom.abs() < 1e-9, torch.full_like(denom, 1e-9), denom)
    t = torch.where((t > 0.2) & (denom.abs() > 1e-6), t, float("inf"))
    tmin, plane = torch.min(t, dim=-1)
    return tmin, plane, torch.isfinite(tmin)


def _shade(world: World, X: torch.Tensor, plane: torch.Tensor) -> torch.Tensor:
    """Texture lookup of world points (..., 3) on their hit planes: three
    self-similar octaves (1×, 5×, 13×)."""
    s = world.tex_scale[plane]
    u = torch.einsum("...k,...k->...", X, world.e1[plane]) * s
    v = torch.einsum("...k,...k->...", X, world.e2[plane]) * s
    out = torch.zeros_like(u)
    for p in range(world.tex.shape[0]):
        t = world.tex[p]
        val = (0.5 * _sample_tex(t, u, v)
               + 0.35 * _sample_tex(t, 5.0 * u + 11.0, 5.0 * v + 7.0)
               + 0.15 * _sample_tex(t, 13.0 * u + 3.0, 13.0 * v + 29.0))
        out = torch.where(plane == p, val, out)
    return out


def _pose(Twc, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(Twc, np.float32), device=device)


def render_image(world: World, Twc, fx: float, fy: float, cx: float, cy: float,
                 height: int, width: int, ss: int = 2) -> torch.Tensor:
    """(H, W) grayscale view from camera pose Twc (7,), supersampled
    ``ss``× per axis and box-averaged."""
    dev = world.tex.device
    Twc = _pose(Twc, dev)
    Hs, Ws = height * ss, width * ss
    ys = (torch.arange(Hs, dtype=torch.float32, device=dev) + 0.5) / ss
    xs = (torch.arange(Ws, dtype=torch.float32, device=dev) + 0.5) / ss
    v, u = torch.meshgrid(ys, xs, indexing="ij")
    d_cam = torch.stack([(u - cx) / fx, (v - cy) / fy, torch.ones_like(u)], dim=-1)
    R = lie.quat_to_matrix(Twc[:4])
    d_w = torch.einsum("ij,hwj->hwi", R, d_cam)
    o = Twc[4:7].expand(d_w.shape)
    t, plane, hit = _cast(world, o, d_w)
    X = o + torch.where(hit, t, 0.0)[..., None] * d_w
    img = torch.where(hit, _shade(world, X, plane), 0.0)
    if ss > 1:
        img = img.reshape(height, ss, width, ss).mean(dim=(1, 3))
    return img


def lidar_scan(world: World, Twc, n_az: int = 512, n_el: int = 64, az_fov: float = 1.2,
               el_lo: float = -0.42, el_hi: float = 0.05) -> torch.Tensor:
    """Velodyne-frame scan (n_az·n_el, 4): forward-sector azimuth sweep ×
    elevation fan, [x, y, z, 1] with misses at the origin (the min-dist
    gate drops them downstream)."""
    dev = world.tex.device
    Twc = _pose(Twc, dev)
    az = torch.linspace(-az_fov, az_fov, n_az, device=dev)
    el = torch.linspace(el_lo, el_hi, n_el, device=dev)
    E, A = torch.meshgrid(el, az, indexing="ij")
    d_v = torch.stack([torch.cos(E) * torch.cos(A), torch.cos(E) * torch.sin(A),
                       torch.sin(E)], dim=-1)
    Tvc = torch.from_numpy(T_VELO_CAM).to(dev)
    d_c = torch.einsum("ij,hwj->hwi", Tvc[:, :3], d_v)
    R = lie.quat_to_matrix(Twc[:4])
    o_w = R @ Tvc[:, 3] + Twc[4:7]
    d_w = torch.einsum("ij,hwj->hwi", R, d_c)
    t, _, hit = _cast(world, o_w.expand(d_w.shape), d_w)
    pts = (d_v * torch.where(hit, t, 0.0)[..., None]).reshape(-1, 3)
    return torch.cat([pts, torch.ones((pts.shape[0], 1), device=dev)], dim=1)


def straight_trajectory(n: int, step: float = 0.8, yaw_rate: float = 0.0,
                        weave: float = 0.0) -> np.ndarray:
    """(n, 7) Twc ground truth: forward motion with optional constant yaw
    and lateral weave."""
    poses = []
    x, z, yaw = 0.0, 0.0, 0.0
    for i in range(n):
        q = np.array([np.cos(yaw / 2), 0.0, np.sin(yaw / 2), 0.0], np.float32)
        t = np.array([x + weave * np.sin(0.15 * i), 0.0, z], np.float32)
        poses.append(np.concatenate([q, t]))
        x += step * np.sin(yaw)
        z += step * np.cos(yaw)
        yaw += yaw_rate
    return np.stack(poses).astype(np.float32)


def multi_loop_trajectory(n: int, radius: float = 18.0, period: int = 84) -> np.ndarray:
    """(n, 7) Twc of a continuous multi-lap circle through the origin:
    ``period`` frames per revolution, the phase keeps advancing, so there is
    no pose jump at the lap seam."""
    th = 2.0 * np.pi * np.arange(n) / period
    zeros = np.zeros(n)
    return np.stack([np.cos(th / 2), zeros, np.sin(th / 2), zeros,
                     radius * (1.0 - np.cos(th)), zeros, radius * np.sin(th)],
                    axis=1).astype(np.float32)


def loop_trajectory(n: int, radius: float = 18.0) -> np.ndarray:
    """(n, 7) Twc of one circular lap that returns to its start."""
    return multi_loop_trajectory(n, radius, period=n)


def twc_to_tcw(Twc: np.ndarray) -> np.ndarray:
    return lie.np_se3_inv(np.asarray(Twc, np.float32))


def synthetic_rgbl_config(width: int = 320, height: int = 192, n_features: int = 600,
                          n_levels: int = 4):
    """RGB-L SlamConfig matched to this world's camera/LiDAR geometry
    (small shapes, CPU-testable)."""
    from orb_slam3_rgbl_tpu_torch.config import LidarConfig, OrbConfig, RGBL, SlamConfig
    from orb_slam3_rgbl_tpu_torch.geometry.camera import PinholeCamera

    fx = float(width)
    return SlamConfig(
        sensor=RGBL,
        camera=PinholeCamera(fx=fx, fy=fx, cx=width / 2.0, cy=height / 2.0,
                             width=width, height=height, bf=0.5 * fx, th_depth=100.0),
        orb=OrbConfig(n_features=n_features, scale_factor=1.2, n_levels=n_levels,
                      ini_th_fast=12, min_th_fast=7),
        lidar=LidarConfig(T_velo_cam=tuple(T_VELO_CAM.reshape(-1).tolist()),
                          method="InverseDilation", min_dist=1.5, max_dist=150.0,
                          dil_kernel_type="Diamond", dil_kernel_size_u=5, dil_kernel_size_v=7),
        fps=10.0, max_keyframes=512, max_map_points=65536,
    )
