"""Port vs JAX: ``System.track_rgbl`` (tracking-only) over 30 frames
under the natural keyframe policy, then 12 textureless frames and 3
textured ones, and the trajectory savers. Helpers, tolerances and the
one-thread fixture: test_torch_system.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from orb_slam3_rgbl_tpu import synthetic as j_syn
from orb_slam3_rgbl_tpu.geometry.align import ate_rmse
from orb_slam3_rgbl_tpu.slam import tracking as j_trk
from orb_slam3_rgbl_tpu_torch.slam import tracking as t_trk
from test_torch_system import (POSE_TOL_M, _centers, _drive, _render, _systems,  # noqa: F401
                               one_torch_thread)

N_NATURAL, N_BLANK, N_AFTER = 30, 12, 3


def _ate(est, traj):
    return float(ate_rmse(jnp.asarray(est[:, 4:7]), jnp.asarray(traj[:, 4:7] - traj[0, 4:7])))


@pytest.fixture(scope="module")
def natural():
    """30 frames under the natural keyframe policy, then 12 textureless
    frames and 3 textured ones."""
    n = N_NATURAL + N_BLANK + N_AFTER
    traj = j_syn.straight_trajectory(n, step=0.6, weave=0.4)
    cfg, frames = _render(traj)
    blank = np.full_like(frames[0][0], 12.0)
    frames = [(blank if N_NATURAL <= i < N_NATURAL + N_BLANK else img, pts)
              for i, (img, pts) in enumerate(frames)]
    js, ts = _systems(cfg)
    log = _drive(js, ts, frames[:N_NATURAL])
    est = (js.trajectory(), ts.trajectory())
    log = _drive(js, ts, frames[N_NATURAL:], t0=N_NATURAL, log=log)
    return traj, js, ts, log, est


def test_natural_policy_drive_and_ate(natural):
    traj, js, ts, log, (est_j, est_t) = natural
    head = log[:N_NATURAL]
    assert all(r[0].state == r[1].state == t_trk.OK for r in head)
    assert abs(head[-1][2] - head[-1][3]) <= 1 and head[-1][3] >= 2
    c_j = _centers([r[0] for r in head])
    c_t = _centers([r[1] for r in head])
    assert np.abs(c_t - c_j).max() < POSE_TOL_M, np.abs(c_t - c_j).max()
    assert all(abs(r[1].n_inliers - r[0].n_inliers) <= 0.05 * r[0].n_inliers for r in head)
    # the bar of tests/test_image_e2e.py
    assert _ate(est_j, traj[:N_NATURAL]) < 0.15
    assert _ate(est_t, traj[:N_NATURAL]) < 0.15


def test_blank_stretch_recovers_through_a_new_map(natural):
    """Textureless frames: OK → RECENTLY_LOST → LOST on both sides; with
    no keyframe database relocalization fails, so after ``fps`` LOST
    frames the atlas archives the map and the next textured frame
    initializes a second one."""
    _, js, ts, log, _ = natural
    tail = log[N_NATURAL:]
    states_j = [r[0].state for r in tail]
    states_t = [r[1].state for r in tail]
    assert states_t == states_j
    assert states_t == ([j_trk.RECENTLY_LOST] + [j_trk.LOST] * (N_BLANK - 1)
                        + [j_trk.OK] * N_AFTER), states_t
    assert js.atlas.n_maps() == ts.atlas.n_maps() == 2
    assert ts.map.n_kf == js.map.n_kf
    n = N_NATURAL + N_BLANK + N_AFTER
    assert len(ts.trajectory()) == len(js.trajectory()) == n
    assert len(ts.timestamps()) == n


def test_trajectory_savers_match_jax(natural, tmp_path):
    """The six savers write the same rows on both sides (camera poses to
    the drive's 5 mm, rotations to 1e-3), and ``load_kitti_poses`` reads a
    KITTI file back as the JAX loader does."""
    from orb_slam3_rgbl_tpu.io import trajectory as j_io
    from orb_slam3_rgbl_tpu_torch.io import trajectory as t_io

    _, js, ts, _, _ = natural
    for name in ("trajectory_kitti", "trajectory_tum", "trajectory_euroc",
                 "keyframe_trajectory_kitti", "keyframe_trajectory_tum",
                 "keyframe_trajectory_euroc"):
        pj, pt = tmp_path / f"j_{name}.txt", tmp_path / f"t_{name}.txt"
        with jax.enable_x64(False):
            getattr(js, "save_" + name)(str(pj))
        getattr(ts, "save_" + name)(str(pt))
        a, b = np.loadtxt(pj, ndmin=2), np.loadtxt(pt, ndmin=2)
        assert a.shape == b.shape and len(a) > 0, name
        np.testing.assert_allclose(b, a, atol=POSE_TOL_M, rtol=0, err_msg=name)
    with jax.enable_x64(False):
        ref = np.asarray(j_io.load_kitti_poses(str(tmp_path / "j_trajectory_kitti.txt")))
    out = t_io.load_kitti_poses(str(tmp_path / "j_trajectory_kitti.txt"))
    np.testing.assert_allclose(out, ref, atol=1e-6)
