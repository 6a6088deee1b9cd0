"""Seeded generator of a whole SLAM map at the moment a loop correction hands
it to the global bundle adjustment: keyframe poses, landmarks, each
keyframe's feature slots bound to the landmarks it observes, and the ground
truth the observations were made from.

numpy only: it imports nothing of the program. One seed gives one map, bit
for bit. The sizes that set the solver's work do not depend on the seed: the
number of keyframes and of landmarks always, and in a ``consecutive`` map the
number of observations of every keyframe too.

The configuration's ``map`` section names two models:

* ``trajectory``: ``drive`` (a car on roads: straight runs and 90-degree
  turns, with the road's pitch and the car's roll) or ``hall_loops`` (a
  hand-held or flying rig circling a hall, so places are seen again);
* ``observers``: ``consecutive`` (a landmark is seen by a run of consecutive
  keyframes whose length comes from a fixed table: the forward drive's
  tracks) or ``all_viewers`` (a landmark is seen by a random subset of every
  keyframe that views it, near or far in time: the revisits of a small
  place).

Poses are Tcw (world to camera) as ``[qw, qx, qy, qz, tx, ty, tz]``, the
world being the first keyframe's camera (x right, y down, z forward).
"""

from __future__ import annotations

import numpy as np


def rng_for(seed: int) -> np.random.Generator:
    """The generator of one run: any whole number is a seed."""
    return np.random.default_rng(int(seed) % 2 ** 64)


# --- rotations ---------------------------------------------------------------

def rot_x(a):
    a = np.asarray(a, np.float64)
    c, s, o, z = np.cos(a), np.sin(a), np.ones_like(a), np.zeros_like(a)
    return np.stack([o, z, z, z, c, -s, z, s, c], -1).reshape(a.shape + (3, 3))


def rot_y(a):
    a = np.asarray(a, np.float64)
    c, s, o, z = np.cos(a), np.sin(a), np.ones_like(a), np.zeros_like(a)
    return np.stack([c, z, s, z, o, z, -s, z, c], -1).reshape(a.shape + (3, 3))


def rot_z(a):
    a = np.asarray(a, np.float64)
    c, s, o, z = np.cos(a), np.sin(a), np.ones_like(a), np.zeros_like(a)
    return np.stack([c, -s, z, s, c, z, z, z, o], -1).reshape(a.shape + (3, 3))


def exp_so3(w: np.ndarray) -> np.ndarray:
    """(n, 3) rotation vectors → (n, 3, 3) matrices (Rodrigues)."""
    th = np.linalg.norm(w, axis=-1)[:, None, None]
    k = w / np.maximum(th[:, :, 0], 1e-300)
    kx = np.zeros(w.shape[:-1] + (3, 3))
    kx[:, 0, 1], kx[:, 0, 2], kx[:, 1, 2] = -k[:, 2], k[:, 1], -k[:, 0]
    kx = kx - np.swapaxes(kx, -1, -2)
    return np.eye(3) + np.sin(th) * kx + (1.0 - np.cos(th)) * (kx @ kx)


def matrix_to_quat(R: np.ndarray) -> np.ndarray:
    """(n, 3, 3) rotations → (n, 4) unit quaternions [w, x, y, z], w ≥ 0."""
    m = R
    t = np.stack([1 + m[:, 0, 0] + m[:, 1, 1] + m[:, 2, 2],
                  1 + m[:, 0, 0] - m[:, 1, 1] - m[:, 2, 2],
                  1 - m[:, 0, 0] + m[:, 1, 1] - m[:, 2, 2],
                  1 - m[:, 0, 0] - m[:, 1, 1] + m[:, 2, 2]], -1)
    i = np.argmax(t, axis=-1)
    s = np.sqrt(np.maximum(t[np.arange(len(m)), i], 1e-300)) * 2.0
    q = np.empty((len(m), 4))
    for c in range(4):
        sel = i == c
        a = m[sel]
        ss = s[sel]
        if c == 0:
            q[sel] = np.stack([0.25 * ss, (a[:, 2, 1] - a[:, 1, 2]) / ss,
                               (a[:, 0, 2] - a[:, 2, 0]) / ss, (a[:, 1, 0] - a[:, 0, 1]) / ss], -1)
        elif c == 1:
            q[sel] = np.stack([(a[:, 2, 1] - a[:, 1, 2]) / ss, 0.25 * ss,
                               (a[:, 0, 1] + a[:, 1, 0]) / ss, (a[:, 0, 2] + a[:, 2, 0]) / ss], -1)
        elif c == 2:
            q[sel] = np.stack([(a[:, 0, 2] - a[:, 2, 0]) / ss, (a[:, 0, 1] + a[:, 1, 0]) / ss,
                               0.25 * ss, (a[:, 1, 2] + a[:, 2, 1]) / ss], -1)
        else:
            q[sel] = np.stack([(a[:, 1, 0] - a[:, 0, 1]) / ss, (a[:, 0, 2] + a[:, 2, 0]) / ss,
                               (a[:, 1, 2] + a[:, 2, 1]) / ss, 0.25 * ss], -1)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    return np.where(q[:, :1] < 0, -q, q)


def quat_to_matrix(q: np.ndarray) -> np.ndarray:
    """(n, 4) quaternions [w, x, y, z] → (n, 3, 3) in float64, normalized
    first."""
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                     2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                     2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
                    -1).reshape(-1, 3, 3)


# --- trajectories (camera → world rotations and centres) ---------------------

def drive_trajectory(n_kf: int, p: dict, rng: np.random.Generator):
    """A car on roads: straight runs of ``straight_m`` (uniform range) and
    turns of ±``turn_deg`` over ``turn_m``, keyframes every ``kf_spacing_m``
    along the path; the road's pitch and the car's roll are slow sines of
    amplitude ``pitch_deg`` / ``roll_deg``. The camera looks along the road."""
    length = n_kf * p["kf_spacing_m"] + 1.0
    step = 0.05
    s = np.arange(0.0, length + step, step)
    rate = np.zeros_like(s)                      # heading change per metre
    pos, turning = 0.0, False
    while pos < length:
        if turning:
            seg = p["turn_m"]
            sign = rng.choice([-1.0, 1.0])
            rate[(s >= pos) & (s < pos + seg)] = sign * np.radians(p["turn_deg"]) / seg
        else:
            seg = rng.uniform(*p["straight_m"])
        pos += seg
        turning = not turning
    heading = np.concatenate([[0.0], np.cumsum(rate[:-1] * step)])
    ph = rng.uniform(0, 2 * np.pi, 2)
    pitch = np.radians(p["pitch_deg"]) * np.sin(2 * np.pi * s / p["undulation_m"] + ph[0])
    roll = np.radians(p["roll_deg"]) * np.sin(2 * np.pi * s / p["undulation_m"] * 1.7 + ph[1])
    fwd = np.stack([np.sin(heading) * np.cos(pitch), -np.sin(pitch),
                    np.cos(heading) * np.cos(pitch)], -1)
    centre = np.concatenate([[np.zeros(3)], np.cumsum(fwd[:-1] * step, axis=0)])
    idx = np.round(np.arange(n_kf) * p["kf_spacing_m"] / step).astype(np.int64)
    R_wc = rot_y(heading[idx]) @ rot_x(pitch[idx]) @ rot_z(roll[idx])
    return R_wc, centre[idx]


def hall_trajectory(n_kf: int, p: dict, rng: np.random.Generator):
    """A rig circling a hall: a loop of radius ``radius_m`` (± ``radius_var_m``)
    at a height that varies by ``height_var_m``, keyframes every
    ``kf_spacing_m`` of arc, the camera looking outwards with a yaw that swings
    by ``yaw_deg`` and a pitch by ``pitch_deg``. Successive loops see the same
    walls again."""
    ph = rng.uniform(0, 2 * np.pi, 4)
    theta = np.arange(n_kf) * p["kf_spacing_m"] / p["radius_m"] + ph[0]
    r = p["radius_m"] + p["radius_var_m"] * np.sin(3 * theta + ph[1])
    y = p["height_var_m"] * np.sin(2 * theta + ph[2])
    centre = np.stack([r * np.cos(theta), y, r * np.sin(theta)], -1)
    yaw = np.radians(p["yaw_deg"]) * np.sin(5 * theta + ph[3])
    pitch = np.radians(p["pitch_deg"]) * np.sin(7 * theta + ph[1])
    # outwards along (cos θ, 0, sin θ): rot_y(β) takes z to (sin β, 0, cos β)
    beta = np.pi / 2 - theta + yaw
    R_wc = rot_y(beta) @ rot_x(pitch)
    return R_wc, centre


TRAJECTORIES = {"drive": drive_trajectory, "hall_loops": hall_trajectory}


# --- the map -----------------------------------------------------------------

def _shares_to_counts(shares: dict, n: int) -> np.ndarray:
    """A table {value: share} → the n values it gives, by largest remainder
    (the same list for every seed)."""
    vals = np.array(sorted(int(k) for k in shares))
    w = np.array([shares[str(v)] for v in vals], np.float64)
    exact = w / w.sum() * n
    cnt = np.floor(exact).astype(np.int64)
    cnt[np.argsort(-(exact - cnt), kind="stable")[: n - cnt.sum()]] += 1
    return np.repeat(vals, cnt)


def _project(R_cw, t_cw, X, cam):
    """Points X (..., 3) in the cameras (..., 3, 3)/(..., 3) → uv (..., 2), z."""
    pc = np.einsum("...ij,...j->...i", R_cw, X) + t_cw
    z = pc[..., 2]
    zs = np.where(np.abs(z) < 1e-9, 1e-9, z)
    u = cam["fx"] * pc[..., 0] / zs + cam["cx"]
    v = cam["fy"] * pc[..., 1] / zs + cam["cy"]
    return np.stack([u, v], -1), z


def _parallax_cos(X, c1, c2):
    """Cosine of the angle between the rays from centres c1 and c2 to X."""
    a, b = X - c1, X - c2
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _in_view(uv, z, cam, margin, zmin, zmax):
    return ((uv[..., 0] >= margin) & (uv[..., 0] < cam["width"] - margin)
            & (uv[..., 1] >= margin) & (uv[..., 1] < cam["height"] - margin)
            & (z >= zmin) & (z <= zmax))


def _sample_in_frustum(R_wc, c, cam, depth, margin, rng):
    """One point per camera (n, …), uniform in pixels and in depth."""
    n = len(c)
    u = rng.uniform(margin, cam["width"] - margin, n)
    v = rng.uniform(margin, cam["height"] - margin, n)
    z = rng.uniform(depth[0], depth[1], n)
    pc = np.stack([(u - cam["cx"]) / cam["fx"] * z, (v - cam["cy"]) / cam["fy"] * z, z], -1)
    return np.einsum("nij,nj->ni", R_wc, pc) + c


MAX_ROUNDS = 200


def _consecutive(R_wc, c, R_cw, t_cw, cam, p, rng):
    """(landmark positions, observation pairs (lm, kf)) of a map whose
    landmarks are seen by runs of consecutive keyframes from the one that
    made them. The runs' lengths come from the same table for every
    keyframe, so every keyframe's count of observations is the same for
    every seed; a run that would pass the last keyframe ends there (the map
    is a snapshot of a drive that goes on)."""
    K = len(c)
    n_new = p["new_landmarks_per_kf"]
    lengths = _shares_to_counts(p["track_length_share"], n_new)
    birth = np.repeat(np.arange(K), n_new)
    n = np.minimum(np.concatenate([rng.permutation(lengths) for _ in range(K)]), K - birth)
    last = birth + n - 1
    M = len(n)
    X = np.empty((M, 3))
    pending = np.arange(M)
    for _ in range(MAX_ROUNDS):
        b, e = birth[pending], last[pending]
        X[pending] = _sample_in_frustum(R_wc[b], c[b], cam, p["depth_m"], p["margin_px"], rng)
        # a landmark seen more than once was triangulated: the rays from its
        # first and last observers part by ORB-SLAM's parallax gate
        ok = (n[pending] == 1) | (_parallax_cos(X[pending], c[b], c[e]) < p["max_parallax_cos"])
        for j in range(int(n.max())):
            k = np.minimum(birth[pending] + j, K - 1)
            uv, z = _project(R_cw[k], t_cw[k], X[pending], cam)
            seen = _in_view(uv, z, cam, p["margin_px"], p["min_view_depth_m"], np.inf)
            ok &= seen | (j >= n[pending])
        pending = pending[~ok]
        if not len(pending):
            break
    else:
        raise RuntimeError(f"{len(pending)} landmarks found no place seen by all their observers")
    lm = np.repeat(np.arange(M), n)
    kf = np.repeat(birth, n) + (np.arange(len(lm)) - np.repeat(np.cumsum(n) - n, n))
    return X, lm, kf


def _all_viewers(R_wc, c, R_cw, t_cw, cam, p, rng, n_features):
    """(landmark positions, observation pairs (lm, kf)) of a map whose
    landmarks are seen by a random subset of every keyframe viewing them."""
    K = len(c)
    n_new = p["new_landmarks_per_kf"]
    birth = np.repeat(np.arange(K), n_new)
    M = len(birth)
    X = np.empty((M, 3))
    view = np.zeros((M, K), bool)
    wide = np.zeros((M, K), bool)             # viewers past the parallax gate
    pending = np.arange(M)
    for _ in range(MAX_ROUNDS):
        b = birth[pending]
        X[pending] = _sample_in_frustum(R_wc[b], c[b], cam, p["depth_m"], p["margin_px"], rng)
        for lo in range(0, len(pending), 4096):
            sel = pending[lo: lo + 4096]
            Xs = X[sel]
            # every landmark in every camera, as one matrix product each
            pc = np.tensordot(Xs, R_cw, axes=([1], [2])) + t_cw[None]      # (n, K, 3)
            z = pc[..., 2]
            zs = np.where(np.abs(z) < 1e-9, 1e-9, z)
            uv = np.stack([cam["fx"] * pc[..., 0] / zs + cam["cx"],
                           cam["fy"] * pc[..., 1] / zs + cam["cy"]], -1)
            view[sel] = _in_view(uv, z, cam, p["margin_px"], p["min_view_depth_m"],
                                 p["max_view_depth_m"])
            # the parallax between the birth keyframe's ray and each camera's
            a = Xs - c[birth[sel]]                                           # (n, 3)
            ab = (a * Xs).sum(-1)[:, None] - a @ c.T                         # a · (X − c_k)
            bb = (Xs * Xs).sum(-1)[:, None] - 2.0 * Xs @ c.T + (c * c).sum(-1)[None]
            cosp = ab / (np.linalg.norm(a, axis=-1)[:, None] * np.sqrt(np.maximum(bb, 0.0)))
            wide[sel] = view[sel] & (cosp < p["max_parallax_cos"])
        view[pending, birth[pending]] = True
        pending = pending[wide[pending].sum(1) < 1]
        if not len(pending):
            break
    else:
        raise RuntimeError(f"{len(pending)} landmarks have no second viewer past the "
                           "parallax gate")
    # the birth keyframe, one viewer past the parallax gate drawn uniformly
    # (the pair that triangulated it), the rest by chance
    others = view.copy()
    others[np.arange(M), birth] = False
    second = np.argmax(np.where(wide, rng.random((M, K)), -1.0), axis=1)
    obs = others & (rng.random((M, K)) < p["observe_probability"])
    required = np.zeros((M, K), bool)
    required[np.arange(M), birth] = True
    required[np.arange(M), second] = True
    obs |= required
    # a keyframe binds at most one landmark per feature: drop chance ones over
    # its feature count
    for k in np.nonzero(obs.sum(0) > n_features)[0]:
        extra = np.nonzero(obs[:, k] & ~required[:, k])[0]
        over = int(obs[:, k].sum()) - n_features
        obs[rng.choice(extra, over, replace=False), k] = False
    lm, kf = np.nonzero(obs)
    return X, lm, kf


def level_shares(n_levels: int, scale_factor: float) -> np.ndarray:
    """ORB's share of the features on each pyramid level (``ORBextractor``:
    the desired count per level falls by 1/scale_factor a level)."""
    f = (1.0 / scale_factor) ** np.arange(n_levels)
    return f / f.sum()


def generate(config: dict, cell: dict, seed: int) -> dict:
    """The map of ``config`` with ``cell['n_keyframes']`` keyframes, from
    ``seed``. Returns numpy arrays: the map as the loop closer hands it over
    (``kf_pose`` Tcw after the correction, ``kf_lm_idx``, ``kf_uv``, ``kf_ur``,
    ``kf_octave`` over every feature slot; ``lm_pos`` after the correction),
    the ground truth (``true_pose``, ``true_lm``) and ``n_obs`` per keyframe."""
    rng = rng_for(seed)
    cam, p, orb = config["camera"], config["map"], config["orb"]
    K, N = int(cell["n_keyframes"]), int(orb["n_features"])
    R_wc, c = TRAJECTORIES[p["trajectory"]](K, p, rng)
    # the first keyframe's camera is the world
    R0, c0 = R_wc[0].copy(), c[0].copy()
    R_wc = R0.T @ R_wc
    c = (c - c0) @ R0
    R_cw = np.swapaxes(R_wc, -1, -2)
    t_cw = -np.einsum("kij,kj->ki", R_cw, c)

    if p["observers"] == "consecutive":
        X, lm, kf = _consecutive(R_wc, c, R_cw, t_cw, cam, p, rng)
    else:
        X, lm, kf = _all_viewers(R_wc, c, R_cw, t_cw, cam, p, rng, N)
    M, n = len(X), len(lm)

    # observations: octave, noise scaled by the octave, outliers, right
    # coordinates
    uv_true, z = _project(R_cw[kf], t_cw[kf], X[lm], cam)
    octave = rng.choice(orb["n_levels"], n, p=level_shares(orb["n_levels"], orb["scale_factor"]))
    sigma = p["noise_px"] * orb["scale_factor"] ** octave
    uv = uv_true + rng.normal(size=(n, 2)) * sigma[:, None]
    # the disparity: from a depth sensor (a relative depth error) or from
    # stereo matching (a pixel error scaled by the octave)
    disp = (cam["bf"] / (z * (1.0 + p["depth_noise_rel"] * rng.normal(size=n)))
            + p["disparity_noise_px"] * sigma * rng.normal(size=n))
    outlier = rng.random(n) < p["outlier_share"]
    ang = rng.uniform(0, 2 * np.pi, n)
    off = p["outlier_px"] * np.stack([np.cos(ang), np.sin(ang)], -1)
    uv = np.where(outlier[:, None], uv_true + off, uv)
    # a landmark's first observation has the right coordinate (the map point
    # was made from that keyframe's depth); the others have it by chance, at
    # the rate that gives the stated share over all observations
    first = np.zeros(n, bool)
    first[np.cumsum(np.bincount(lm, minlength=M)) - np.bincount(lm, minlength=M)] = True
    p_rest = np.clip((p["stereo_share"] * n - M) / max(n - M, 1), 0.0, 1.0)
    stereo = first | (rng.random(n) < p_rest)
    ur = np.where(stereo, uv[:, 0] - disp, -1.0)

    # feature slots: every keyframe holds N features; its observations take
    # distinct random slots, the rest stay unbound
    order = np.argsort(kf, kind="stable")
    counts = np.bincount(kf, minlength=K)
    rank = np.arange(n) - np.repeat(np.cumsum(counts) - counts, counts)
    slots = rng.permuted(np.tile(np.arange(N, dtype=np.int64), (K, 1)), axis=1)
    feat = np.empty(n, np.int64)
    feat[order] = slots[kf[order], rank]
    kf_uv = np.stack([rng.uniform(0, cam["width"], (K, N)),
                      rng.uniform(0, cam["height"], (K, N))], -1).astype(np.float32)
    kf_octave = rng.choice(orb["n_levels"], (K, N),
                           p=level_shares(orb["n_levels"], orb["scale_factor"])).astype(np.int16)
    kf_ur = np.full((K, N), -1.0, np.float32)
    kf_lm_idx = np.full((K, N), -1, np.int32)
    kf_uv[kf, feat] = uv
    kf_octave[kf, feat] = octave
    kf_ur[kf, feat] = ur
    kf_lm_idx[kf, feat] = lm

    # the state after the loop correction: every pose but the first and every
    # landmark off by the stated errors
    e = p["post_correction"]
    dR = exp_so3(rng.normal(size=(K, 3)) * np.radians(e["rot_deg"]) / np.sqrt(3))
    dt = rng.normal(size=(K, 3)) * e["trans_m"] / np.sqrt(3)
    dR[0], dt[0] = np.eye(3), 0.0
    R_est = dR @ R_cw
    t_est = np.einsum("kij,kj->ki", dR, t_cw) + dt
    X_est = X + rng.normal(size=(M, 3)) * e["landmark_m"] / np.sqrt(3)

    def pose7(R, t):
        return np.concatenate([matrix_to_quat(R), t], -1)

    return dict(
        kf_pose=pose7(R_est, t_est).astype(np.float32),
        kf_uv=kf_uv, kf_ur=kf_ur, kf_octave=kf_octave, kf_lm_idx=kf_lm_idx,
        lm_pos=X_est.astype(np.float32),
        true_pose=pose7(R_cw, t_cw), true_lm=X,
        n_obs=counts,
    )


def inv_sigma2(orb: dict) -> np.ndarray:
    """1 / σ² of each pyramid level (ORB's ``mvInvLevelSigma2``)."""
    return (1.0 / np.float64(orb["scale_factor"]) ** (2 * np.arange(orb["n_levels"]))).astype(
        np.float32)
