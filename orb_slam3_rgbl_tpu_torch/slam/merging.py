"""Multi-map merging, the atlas weld (counterpart of
``orb_slam3_rgbl_tpu.slam.merging``; reference ``LoopClosing::MergeLocal``,
``LoopClosing.cc:1215-1782``).

After a hard loss the active map is archived and tracking starts a fresh
map at an arbitrary origin. When a keyframe of the active map recognizes a
place that an archived map holds, ``verify_cross_map`` checks it
geometrically (descriptor match on landmark-bound features → Sim3 RANSAC →
refinement) and the two maps are welded: the Sim3 between the matched
keyframes gives the similarity ``S_w2←w1`` between the two world frames,
``merge_maps`` transports the whole active map into the archived map's
frame and appends its keyframes and landmarks, and ``apply_fusion``
replaces the verified duplicate landmarks with their archived twins. The
archived map keeps its frame and ids, as the reference keeps the matched
map.

The descriptor match and the two Sim3 solvers run on the caller's device
with the real number of pairs; the weld itself is host numpy on
``MapState``, as in the JAX package. The inertial arrays have no
counterpart in the port's map yet, so nothing of them is transported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from orb_slam3_rgbl_tpu_torch.config import SlamConfig
from orb_slam3_rgbl_tpu_torch.device import resolve
from orb_slam3_rgbl_tpu_torch.geometry import lie
from orb_slam3_rgbl_tpu_torch.ops import matching
from orb_slam3_rgbl_tpu_torch.optim import sim3 as sim3_opt
from orb_slam3_rgbl_tpu_torch.slam.local_mapping import _i32_words
from orb_slam3_rgbl_tpu_torch.slam.loop_closing import RANSAC_HYPOTHESES
from orb_slam3_rgbl_tpu_torch.slam.map_state import INVALID, MapState

MERGE_SPANS = ("merge.verify", "merge.weld", "merge.ba")


@dataclasses.dataclass
class MergeEvent:
    kf_cur: int            # keyframe id in the ACTIVE map
    kf_matched: int        # keyframe id in the ARCHIVED map
    entry_idx: int         # atlas index of the archived map
    n_inliers: int
    S12: np.ndarray        # Sim3 c_cur ← c_matched
    fusion: Tuple[np.ndarray, np.ndarray]  # (active lm ids, archived lm ids)


@dataclasses.dataclass
class MergeResult:
    map: MapState          # the welded map (archived map's arrays, extended)
    kf_remap: np.ndarray   # (active.capacity_kf,) old-active kf id → merged id
    lm_remap: np.ndarray   # (active.capacity_lm + 1,) active lm id → merged id
    S_w2_w1: np.ndarray    # Sim3 archived-world ← active-world
    kf_cur_new: int        # merged id of the event's current keyframe
    appended_kfs: np.ndarray  # merged ids of all transported keyframes


def verify_cross_map(cfg: SlamConfig, m1: MapState, kf1: int, m2: MapState, kf2: int,
                     fix_scale: bool, generator: Optional[torch.Generator] = None,
                     draws: Optional[torch.Tensor] = None, device=None
                     ) -> Optional[Tuple[np.ndarray, int, Tuple[np.ndarray, np.ndarray]]]:
    """Geometric verification of a cross-map place-recognition candidate
    (the ladder of the in-map loop verification, ``DetectCommonRegionsFromBoW``
    LoopClosing.cc:578-897, without the guided pass). The RANSAC draws come
    from the caller's ``generator`` or ``draws``. Returns (S12 = Sim3
    c1←c2, n_inliers, (lm1, lm2) fusion pairs) or None."""
    dev = resolve(device)
    b1 = m1.kf_lm_idx[kf1] >= 0
    b2 = m2.kf_lm_idx[kf2] >= 0
    if b1.sum() < 20 or b2.sum() < 20:
        return None

    def up(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    d = matching.distance_table(up(_i32_words(m1.kf_desc[kf1]), torch.int32),
                                up(_i32_words(m2.kf_desc[kf2]), torch.int32),
                                up(b1, torch.bool), up(b2, torch.bool))
    idx, _ = matching.mutual_best_match(d, th=matching.TH_LOW, ratio=0.75, check_rotation=False)
    idx = idx.cpu().numpy()
    f1 = np.nonzero(idx >= 0)[0]
    if f1.size < 20:
        return None
    f2 = idx[f1]
    lm1 = m1.kf_lm_idx[kf1, f1]
    lm2 = m2.kf_lm_idx[kf2, f2]
    ok = m1.lm_valid[lm1] & m2.lm_valid[lm2]
    f1, f2, lm1, lm2 = f1[ok], f2[ok], lm1[ok], lm2[ok]
    if f1.size < 20:
        return None

    f32 = torch.float32
    p1 = up(lie.np_se3_apply(m1.kf_pose[kf1], m1.lm_pos[lm1]), f32)
    p2 = up(lie.np_se3_apply(m2.kf_pose[kf2], m2.lm_pos[lm2]), f32)
    uv1, uv2 = up(m1.kf_uv[kf1, f1], f32), up(m2.kf_uv[kf2, f2], f32)
    s1 = up((cfg.orb.scale_factor ** (2 * m1.kf_octave[kf1, f1])).astype(np.float32), f32)
    s2 = up((cfg.orb.scale_factor ** (2 * m2.kf_octave[kf2, f2])).astype(np.float32), f32)
    res = sim3_opt.sim3_ransac(p1, p2, uv1, uv2, s1, s2,
                               torch.ones(f1.size, dtype=torch.bool, device=dev), cfg.camera,
                               generator=generator, n_hypotheses=RANSAC_HYPOTHESES,
                               fix_scale=fix_scale, draws=draws)
    # the refinement is enqueued before the RANSAC count is read: one
    # download serves both gates
    S12, inl, n = sim3_opt.optimize_sim3(res.S12, p1, p2, uv1, uv2, 1.0 / s1, 1.0 / s2,
                                         res.inliers, cfg.camera, fix_scale=fix_scale)
    down = torch.cat([S12, res.n_inliers[None].to(f32), n[None].to(f32), inl.to(f32)]).cpu().numpy()
    n_ransac, n = int(down[8]), int(down[9])
    if n_ransac < 20 or n < 25:
        return None
    inl_np = down[10:] > 0.5
    return down[:8].astype(np.float32), n, (lm1[inl_np], lm2[inl_np])


def world_alignment(S12: np.ndarray, T_c1_w1: np.ndarray, T_c2_w2: np.ndarray) -> np.ndarray:
    """Sim3 ``S_w2←w1`` aligning the active world frame (w1) to the
    archived one (w2), from the camera-frame constraint ``X_c1 = S12 · X_c2``:
    S_c1_w2 = S12 ∘ T_c2_w2, and S_w2_w1 = S_c1_w2⁻¹ ∘ T_c1_w1."""
    S_c1_w2 = lie.np_sim3_mul(np.asarray(S12), lie.np_sim3_from_se3(T_c2_w2))
    S_w2_w1 = lie.np_sim3_mul(lie.np_sim3_inv(S_c1_w2), lie.np_sim3_from_se3(T_c1_w1))
    return S_w2_w1.astype(np.float32)


def merge_maps(old: MapState, active: MapState, ev_kf_cur: int,
               S_w2_w1: np.ndarray) -> MergeResult:
    """Weld ``active`` into ``old``: the archived map keeps its frame and
    ids and grows to hold the transported keyframes and landmarks (Sim3
    transport, block copy, id remaps). Duplicate landmarks are fused
    afterwards by :func:`apply_fusion`."""
    S = np.asarray(S_w2_w1, np.float32)
    s = float(S[7])
    kfs = active.valid_kf_ids()
    lms = np.nonzero(active.lm_valid)[0]
    nK, nL = kfs.size, lms.size
    if old.n_kf + nK > old.capacity_kf:
        old._grow_keyframes(old.n_kf + nK)
    if old.n_lm + nL > old.capacity_lm:
        old._grow_landmarks(nL)

    # poses: T_ck_w2 = se3(sim3(T_ck_w1) ∘ S_w1_w2); landmarks: X_w2 = S_w2_w1 · X_w1
    new_poses = lie.np_sim3_to_se3(lie.np_sim3_mul(lie.np_sim3_from_se3(active.kf_pose[kfs]),
                                                   lie.np_sim3_inv(S)[None, :]))
    new_lm_pos = lie.np_sim3_apply(S, active.lm_pos[lms])
    # normals rotate (unit length preserved); distance bands scale by s
    new_normals = lie.np_quat_rotate(S[None, :4], active.lm_normal[lms]).astype(np.float32)

    kf_remap = np.full(active.capacity_kf, INVALID, np.int32)
    kf_remap[kfs] = old.n_kf + np.arange(nK, dtype=np.int32)
    lm_remap = np.full(active.capacity_lm + 1, INVALID, np.int32)
    lm_remap[lms] = old.n_lm + np.arange(nL, dtype=np.int32)
    new_kf_ids = kf_remap[kfs]
    new_lm_ids = lm_remap[lms]

    old.kf_pose[new_kf_ids] = new_poses
    old.kf_valid[new_kf_ids] = True
    old.kf_timestamp[new_kf_ids] = active.kf_timestamp[kfs]
    old.kf_frame_id[new_kf_ids] = active.kf_frame_id[kfs]
    old.kf_uv[new_kf_ids] = active.kf_uv[kfs]
    old.kf_octave[new_kf_ids] = active.kf_octave[kfs]
    old.kf_desc[new_kf_ids] = active.kf_desc[kfs]
    # depth and pseudo-stereo are metric in w1, and w2 units are s× w1 units
    d = active.kf_depth[kfs]
    old.kf_depth[new_kf_ids] = np.where(d > 0, d * s, d)
    ur = active.kf_ur[kfs]
    uu = active.kf_uv[kfs][..., 0]
    old.kf_ur[new_kf_ids] = np.where((ur >= 0) & (d > 0), uu - (uu - ur) / s, -1.0)
    old.kf_feat_valid[new_kf_ids] = active.kf_feat_valid[kfs]
    old.kf_angle[new_kf_ids] = active.kf_angle[kfs]
    tbl = active.kf_lm_idx[kfs]
    old.kf_lm_idx[new_kf_ids] = np.where(tbl >= 0, lm_remap[np.clip(tbl, 0, None)], INVALID)

    old.lm_pos[new_lm_ids] = new_lm_pos
    old.lm_valid[new_lm_ids] = True
    old.lm_desc[new_lm_ids] = active.lm_desc[lms]
    old.lm_normal[new_lm_ids] = new_normals
    old.lm_max_dist[new_lm_ids] = active.lm_max_dist[lms] * s
    old.lm_min_dist[new_lm_ids] = active.lm_min_dist[lms] * s
    old.lm_ref_kf[new_lm_ids] = kf_remap[np.clip(active.lm_ref_kf[lms], 0, None)]
    old.lm_first_kf[new_lm_ids] = kf_remap[np.clip(active.lm_first_kf[lms], 0, None)]
    old.lm_visible[new_lm_ids] = active.lm_visible[lms]
    old.lm_found[new_lm_ids] = active.lm_found[lms]

    old.n_kf += nK
    old.n_lm += nL
    old.version += 1
    return MergeResult(map=old, kf_remap=kf_remap, lm_remap=lm_remap, S_w2_w1=S,
                       kf_cur_new=int(kf_remap[ev_kf_cur]), appended_kfs=new_kf_ids)


def apply_fusion(m: MapState, cur_lms: np.ndarray, old_lms: np.ndarray) -> np.ndarray:
    """Replace transported duplicates with their archived twins in every
    binding (``SearchAndFuse`` / ``MapPoint::Replace``). ``cur_lms`` are
    merged-map ids of the active-side landmarks. Returns the landmark remap
    (capacity_lm + 1,) for rebinding outside state."""
    remap = np.arange(m.capacity_lm + 1, dtype=np.int32)
    remap[-1] = INVALID
    keep = cur_lms != old_lms
    remap[cur_lms[keep]] = old_lms[keep]
    bound = m.kf_lm_idx >= 0
    m.kf_lm_idx[bound] = remap[m.kf_lm_idx[bound]]
    losers = np.unique(cur_lms[keep])
    m.lm_valid[losers] = False
    m.lm_gen[losers] += 1
    m.lm_free.extend(int(i) for i in losers)
    m.version += 1
    return remap
