"""The comparison that decides ``correct``: a solve's poses, landmarks and
cost against the plain reference's, as numbers each held to a limit of the
cell's (``limits`` in its workload file).

* ``pose_gap_m``: the largest distance between a keyframe's camera centre in
  the two results;
* ``pose_gap_deg``: the largest angle between a keyframe's two rotations;
* ``landmark_gap_px``: the largest distance, in pixels, between a landmark's
  two positions as the first keyframe that observes it sees them through the
  reference's pose: (u, v, u_R), the right coordinate carrying the depth.
  A landmark that the drive's maps hold weakly in depth can travel hundreds
  of metres along its ray in either result while its image moves a fraction
  of a pixel; a landmark behind that camera in either result reads infinite;
* ``cost_gap``: the gap between the two final costs, as a share of the
  reference's.

A value that is not finite exceeds every limit.

A comparison that the map as it was handed over would pass cannot tell a
sound solve from one that returns its state unchanged: where the reference
kept no step (the program's damping restarts with every call, so on some
maps every step is rejected), its answer is the map itself. ``unchanged``
reads the map as it was handed over against the reference; a run is correct
only where that reading fails the limits.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from slambench.mapgen import quat_to_matrix

NAMES = ("pose_gap_m", "pose_gap_deg", "landmark_gap_px", "cost_gap")


class Reference(NamedTuple):
    R: np.ndarray          # (K, 3, 3) world → camera
    t: np.ndarray          # (K, 3)
    X: np.ndarray          # (M, 3)
    cost: float
    first_kf: np.ndarray   # (M,) the first keyframe observing each landmark
    cam: dict


def against(solution, maparr: dict, cam: dict) -> Reference:
    """A reference solution (R, t, X, cost) with what the landmark gap needs
    of its map: each landmark's first observer, and the camera."""
    kf, feat = np.nonzero(maparr["kf_lm_idx"] >= 0)
    lm = maparr["kf_lm_idx"][kf, feat]
    first = np.full(len(maparr["lm_pos"]), len(maparr["kf_lm_idx"]), np.int64)
    np.minimum.at(first, lm, kf)
    return Reference(*solution, first, cam)


def _image(R, t, X, cam):
    """(u, v, u_R) of points X in cameras (R, t); NaN behind the camera."""
    p = np.einsum("mij,mj->mi", R, X) + t
    z = np.where(p[:, 2] > 1e-3, p[:, 2], np.nan)
    u = cam["fx"] * p[:, 0] / z + cam["cx"]
    return np.stack([u, cam["fy"] * p[:, 1] / z + cam["cy"], u - cam["bf"] / z], -1)


def gaps(poses: np.ndarray, landmarks: np.ndarray, cost: float, ref: Reference) -> dict:
    """The compared numbers of one program result (poses (K, 7) Tcw as
    quaternion and translation, landmarks (M, 3), cost) against ``ref``."""
    R_ref, t_ref, X_ref, cost_ref = ref.R, ref.t, ref.X, ref.cost
    R = quat_to_matrix(poses[:, :4])
    t = np.asarray(poses[:, 4:7], np.float64)
    c = -np.einsum("kji,kj->ki", R, t)
    c_ref = -np.einsum("kji,kj->ki", R_ref, t_ref)
    rel = np.einsum("kij,klj->kil", R, R_ref)
    cos = np.clip((np.trace(rel, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    return {
        "pose_gap_m": float(np.max(np.linalg.norm(c - c_ref, axis=1))),
        "pose_gap_deg": float(np.degrees(np.max(np.arccos(cos)))),
        "landmark_gap_px": _landmark_gap_px(np.asarray(landmarks, np.float64), ref),
        "cost_gap": float(abs(cost - cost_ref) / abs(cost_ref)),
    }


def _landmark_gap_px(X: np.ndarray, ref: Reference) -> float:
    R, t = ref.R[ref.first_kf], ref.t[ref.first_kf]
    d = np.linalg.norm(_image(R, t, X, ref.cam) - _image(R, t, ref.X, ref.cam), axis=1)
    return float(np.inf) if np.isnan(d).any() else float(np.max(d))


def unchanged(maparr: dict, start_cost: float, ref) -> dict:
    """The numbers that a solve returning the map unchanged would read:
    the map's poses and landmarks as handed over, and ``start_cost``, the
    reference's plain cost of them."""
    return gaps(maparr["kf_pose"], maparr["lm_pos"], start_cost, ref)


def passes(g: dict, limits: dict) -> bool:
    return all(np.isfinite(g[k]) and g[k] <= limits[k] for k in NAMES)


def worst(all_gaps: list) -> dict:
    """The largest reading of each number over the compared results (NaN
    counts as the largest)."""
    out = {}
    for k in NAMES:
        vals = [g[k] for g in all_gaps]
        out[k] = float("nan") if any(not np.isfinite(v) for v in vals) else max(vals)
    return out
