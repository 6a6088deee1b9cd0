"""The fused per-frame tracking step (counterpart of
``orb_slam3_rgbl_tpu.slam.compiled``): image + LiDAR cloud (or depth image,
or nothing for the monocular sensor) in → features, bindings and pose out,
with no host round-trip inside the step.

Covers reference ``Tracking::Track`` stages: Frame ctor (extraction +
LiDAR depth), TrackWithMotionModel (SearchByProjection against the last
frame + PoseOptimization) and TrackLocalMap (projection search against a
device-resident landmark window + PoseOptimization). Everything the host
control loop reads comes back as ONE f32 vector (``packed``).

Each stage of the step runs inside a ``torch.profiler.record_function``
span named ``track.<stage>`` (``STEP_SPANS``), so a profiler trace splits
the step's host and device time by stage; with no profiler active a span
costs two host-side calls and no device work.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from orb_slam3_rgbl_tpu_torch.config import SlamConfig
from orb_slam3_rgbl_tpu_torch.device import resolve
from orb_slam3_rgbl_tpu_torch.geometry import lie
from orb_slam3_rgbl_tpu_torch.ops import depth as depth_ops
from orb_slam3_rgbl_tpu_torch.ops import matching
from orb_slam3_rgbl_tpu_torch.optim import pose_opt
from orb_slam3_rgbl_tpu_torch.slam import frame as frame_mod


STEP_SPANS = ("track.extract", "track.depth", "track.motion_match", "track.motion_pose",
              "track.window_match", "track.window_pose", "track.pack")


def lidar_projection(cfg: SlamConfig, device) -> torch.Tensor:
    """The (3, 4) LiDAR projection K·T_velo→cam of ``cfg`` on ``device``."""
    P = depth_ops.lidar_projection_matrix(cfg.camera.K, np.asarray(cfg.lidar.T_velo_cam))
    return torch.from_numpy(P).to(device)


def extract(cfg: SlamConfig, img, device) -> frame_mod.FrameFeatures:
    """``frame.extract_features`` with ``cfg``'s ORB settings."""
    cam = cfg.camera
    return frame_mod.extract_features(
        img, cam.height, cam.width, n_features=cfg.orb.n_features,
        n_levels=cfg.orb.n_levels, scale_factor=cfg.orb.scale_factor,
        ini_th=float(cfg.orb.ini_th_fast), min_th=float(cfg.orb.min_th_fast),
        device=device)


def attach_lidar(cfg: SlamConfig, feats, points, P, valid_mask):
    """``frame.attach_lidar_depth`` with ``cfg``'s LiDAR settings."""
    cam, lc = cfg.camera, cfg.lidar
    feats, _ = frame_mod.attach_lidar_depth(
        feats, points, P, cam.height, cam.width, cam.bf,
        min_dist=lc.min_dist, max_dist=lc.max_dist, method=lc.method,
        dil_kind=lc.dil_kernel_type, dil_ku=lc.dil_kernel_size_u,
        dil_kv=lc.dil_kernel_size_v, valid_mask=valid_mask)
    return feats


STEP_MODES = ("rgbl", "rgbd", "mono")


def attach_depth(cfg: SlamConfig, mode: str, feats, depth_src, depth_valid, P):
    """The frame's depth by ``mode``: the LiDAR cloud ``depth_src`` with its
    mask ``depth_valid`` ('rgbl', through the projection ``P``), the
    metric (H, W) depth image ``depth_src`` ('rgbd'), or none ('mono': the
    features keep depth −1)."""
    if mode == "mono":
        return feats
    if mode == "rgbd":
        return frame_mod.attach_depth_map(feats, depth_src, cfg.camera.bf)
    return attach_lidar(cfg, feats, depth_src, P, depth_valid)


def make_frame_step(cfg: SlamConfig, device=None):
    """Returns ``fn(img, points, prev_desc, prev_valid, prev_Xw, Tcw_init)
    -> (Tcw, n_inliers, FrameFeatures)``: extraction, LiDAR depth,
    brute-force mutual matching against the previous frame, pose solve."""
    dev = resolve(device)
    cam = cfg.camera
    n_levels = cfg.orb.n_levels
    inv_s2 = frame_mod.inv_scale_sigma2(n_levels, cfg.orb.scale_factor, dev)
    P = lidar_projection(cfg, dev)

    def fn(img, points, prev_desc, prev_valid, prev_Xw, Tcw_init):
        feats = attach_lidar(cfg, extract(cfg, img, dev), points, P, None)
        d = matching.distance_table(prev_desc, feats.desc, prev_valid, feats.valid)
        idx, _ = matching.mutual_best_match(d, check_rotation=False,
                                            th=matching.TH_LOW, ratio=0.8)
        matched = idx >= 0
        safe = idx.clamp(0, feats.uv.shape[0] - 1).long()
        obs = pose_opt.PoseObs(
            Xw=prev_Xw, uv=feats.uv[safe], u_right=feats.u_right[safe],
            inv_sigma2=inv_s2[feats.octave[safe].clamp(0, n_levels - 1).long()],
            valid=matched & prev_valid)
        res = pose_opt.pose_optimize(Tcw_init, obs, cam)
        return res.Tcw, res.n_inliers, feats

    return fn


def example_inputs(cfg: SlamConfig, n_points: int = 131072, seed: int = 0, device=None):
    """Representative KITTI-regime inputs (gray image, LiDAR cloud,
    previous-frame descriptors/landmarks, identity pose) drawn from
    ``numpy.random.default_rng(seed)``."""
    dev = resolve(device)
    cam = cfg.camera
    rng = np.random.default_rng(seed)
    img = (rng.uniform(size=(cam.height, cam.width)) * 255.0).astype(np.float32)
    pts = np.stack([rng.uniform(6.0, 80.0, n_points), rng.uniform(-30.0, 30.0, n_points),
                    rng.uniform(-2.0, 3.0, n_points), np.ones(n_points)], axis=1)
    N = cfg.orb.n_features
    prev_desc = rng.integers(0, 2 ** 32, (N, 8), dtype=np.uint32).view(np.int32)
    prev_Xw = np.stack([rng.uniform(-20.0, 20.0, N), rng.uniform(-5.0, 5.0, N),
                        rng.uniform(8.0, 60.0, N)], axis=1)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=dev)

    return (t(img), t(pts), t(prev_desc, torch.int32), torch.ones(N, dtype=torch.bool, device=dev),
            t(prev_Xw), lie.se3_identity(device=dev))


class TrackStepOut(NamedTuple):
    Tcw: torch.Tensor            # (7,) final pose
    n_inliers: torch.Tensor      # () i32 — final TrackLocalMap inliers
    n_mm_inliers: torch.Tensor   # () i32 — motion-model stage inliers
    bind_prev: torch.Tensor      # (N,) i32 → prev-frame feature slot or −1
    bind_win: torch.Tensor       # (N,) i32 → local-window slot or −1
    feats: frame_mod.FrameFeatures
    next_Xw: torch.Tensor        # (N, 3) landmark position per bound feature
    next_bound: torch.Tensor     # (N,) bool
    win_visible: torch.Tensor    # (LW,) bool — frustum-passed window slots
    n_tracked_close: torch.Tensor     # () i32 — keyframe policy scalars
    n_nontracked_close: torch.Tensor  # () i32
    # everything the host control loop reads, as ONE f32 vector —
    # [n_inl, n_mm, n_tc, n_ntc, Tcw(7), bind_prev(N), bind_win(N),
    # win_visible(LW)] — so the per-frame host sync is a single download
    packed: torch.Tensor         # (4 + 7 + 2N + LW,) f32


def _resolve_collisions(idx: torch.Tensor, dist: torch.Tensor, n_feat: int) -> torch.Tensor:
    """Per-projection matches (P,) → feature into injective per-feature
    bindings (N,) → projection, keeping the lowest distance (ties broken by
    projection slot). The key dist·16384 + slot is exact in f32
    (256·16384 + 8192 < 2²⁴); unmatched entries go to a dump slot."""
    P = idx.shape[0]
    dev = idx.device
    matched = idx >= 0
    safe = torch.where(matched, idx, n_feat).long()
    slot = torch.arange(P, device=dev)
    key = torch.where(matched, dist * 16384.0 + slot.to(torch.float32), float("inf"))
    best = torch.full((n_feat + 1,), float("inf"), device=dev).scatter_reduce(
        0, safe, key, reduce="amin", include_self=True)
    winner = matched & (key <= best[safe])
    target = torch.where(winner, safe, n_feat)
    bind = torch.full((n_feat + 1,), -1, dtype=torch.int32, device=dev)
    bind = bind.scatter(0, target, slot.to(torch.int32))
    return bind[:n_feat]


def make_track_step(cfg: SlamConfig, window_cap: int = 8192, mm_th: float = 15.0,
                    local_th: float = 4.0, mode: str = "rgbl", device=None):
    """Returns the full tracking step

    fn(img, depth_src, depth_valid, Tcw_pred,
       prev_uv, prev_desc, prev_oct, prev_angle, prev_Xw, prev_bound,
       win_pos, win_desc, win_maxdist, win_valid) -> TrackStepOut

    ``mode`` 'rgbl': ``depth_src`` is a fixed-capacity (Np, 4) LiDAR cloud
    with ``depth_valid`` masking real returns; 'rgbd': ``depth_src`` is the
    (H, W) metric depth image (``Frame::ComputeStereoFromRGBD``) and
    ``depth_valid`` is ignored; 'mono': no depth source (``depth_src`` and
    ``depth_valid`` are ignored), every residual is monocular."""
    if mode not in STEP_MODES:
        raise ValueError(f"make_track_step: unknown mode {mode!r}, expected one of {STEP_MODES}")
    dev = resolve(device)
    cam = cfg.camera
    H, W = cam.height, cam.width
    n_levels = cfg.orb.n_levels
    log_sf = float(np.log(cfg.orb.scale_factor))
    inv_s2 = frame_mod.inv_scale_sigma2(n_levels, cfg.orb.scale_factor, dev)
    sf = torch.tensor([cfg.orb.scale_factor ** l for l in range(n_levels)],
                      dtype=torch.float32, device=dev)
    P_lidar = lidar_projection(cfg, dev)
    th_depth_m = cam.bf * cam.th_depth / cam.fx

    def project(Tcw, X):
        pc = lie.se3_apply(Tcw, X)
        z = pc[:, 2]
        zs = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
        u = cam.fx * pc[:, 0] / zs + cam.cx
        v = cam.fy * pc[:, 1] / zs + cam.cy
        ok = (z > 0.1) & (u >= 0) & (u < W) & (v >= 0) & (v < H)
        return torch.stack([u, v], dim=1), ok

    def solve(Tcw0, feats, Xw, bound):
        obs = pose_opt.PoseObs(
            Xw=Xw, uv=feats.uv, u_right=feats.u_right,
            inv_sigma2=inv_s2[feats.octave.clamp(0, n_levels - 1).long()],
            valid=bound & feats.valid)
        return pose_opt.pose_optimize(Tcw0, obs, cam)

    def fn(img, depth_src, depth_valid, Tcw_pred,
           prev_uv, prev_desc, prev_oct, prev_angle, prev_Xw, prev_bound,
           win_pos, win_desc, win_maxdist, win_valid):
        del prev_uv  # (kept in the signature, as in the JAX step)
        # ---- Frame ctor: extraction + depth ----------------------------
        with record_function("track.extract"):
            feats = extract(cfg, img, dev)
        with record_function("track.depth"):
            feats = attach_depth(cfg, mode, feats, depth_src, depth_valid, P_lidar)
        N = feats.uv.shape[0]

        # ---- TrackWithMotionModel --------------------------------------
        with record_function("track.motion_match"):
            proj1, ok1 = project(Tcw_pred, prev_Xw)
            ok1 = ok1 & prev_bound
            r1 = mm_th * sf[prev_oct.clamp(0, n_levels - 1).long()]
            idx1, d1 = matching.windowed_projection_match(
                proj1, ok1, prev_desc, prev_oct, feats.uv, feats.valid,
                feats.desc, feats.octave, r1, th=matching.TH_HIGH,
                proj_angle=prev_angle, kp_angle=feats.angle)
            bind1 = _resolve_collisions(idx1, d1, N)
            Xw1 = prev_Xw[bind1.clamp(0, N - 1).long()]
        with record_function("track.motion_pose"):
            res1 = solve(Tcw_pred, feats, Xw1, bind1 >= 0)
            keep1 = (bind1 >= 0) & res1.inliers & feats.valid
            # motion-model failure → the prediction pose seeds the local-map stage
            pose1 = torch.where(res1.n_inliers >= 10, res1.Tcw, Tcw_pred)

        # ---- TrackLocalMap: window search ------------------------------
        with record_function("track.window_match"):
            proj2, ok2 = project(pose1, win_pos)
            ok2 = ok2 & win_valid
            center = lie.se3_trans(lie.se3_inv(pose1))
            dist_w = torch.linalg.norm(win_pos - center[None, :], dim=-1)
            ratio = win_maxdist / torch.clamp_min(dist_w, 1e-6)
            oct2 = torch.clamp(torch.ceil(torch.log(torch.clamp_min(ratio, 1e-6)) / log_sf),
                               0, n_levels - 1).to(torch.int32)
            r2 = local_th * sf[oct2.long()]
            idx2, d2 = matching.windowed_projection_match(
                proj2, ok2, win_desc, oct2, feats.uv, feats.valid & ~keep1,
                feats.desc, feats.octave, r2, th=matching.TH_HIGH)
            bind2 = torch.where(keep1, -1, _resolve_collisions(idx2, d2, N))
            from2 = bind2 >= 0
            Xw = torch.where(keep1[:, None], Xw1,
                             torch.where(from2[:, None],
                                         win_pos[bind2.clamp(0, window_cap - 1).long()], 0.0))
            bound = keep1 | from2
        with record_function("track.window_pose"):
            res2 = solve(pose1, feats, Xw, bound)
            inl = res2.inliers & bound & feats.valid

        with record_function("track.pack"):
            bind_prev = torch.where(keep1 & inl, bind1, -1)
            bind_win = torch.where(from2 & inl, bind2, -1)
            close = feats.valid & (feats.depth > 0) & (feats.depth < th_depth_m)
            n_tc = (close & inl).sum().to(torch.int32)
            n_ntc = (close & ~inl).sum().to(torch.int32)
            packed = torch.cat([
                torch.stack([res2.n_inliers, res1.n_inliers, n_tc, n_ntc]).to(torch.float32),
                res2.Tcw.to(torch.float32), bind_prev.to(torch.float32),
                bind_win.to(torch.float32), ok2.to(torch.float32)])
        return TrackStepOut(
            Tcw=res2.Tcw, n_inliers=res2.n_inliers, n_mm_inliers=res1.n_inliers,
            bind_prev=bind_prev, bind_win=bind_win, feats=feats,
            next_Xw=torch.where(inl[:, None], Xw, 0.0), next_bound=inl,
            win_visible=ok2, n_tracked_close=n_tc, n_nontracked_close=n_ntc,
            packed=packed)

    return fn
