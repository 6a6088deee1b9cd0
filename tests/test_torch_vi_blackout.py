"""The port's IMU dead-reckoning through a blackout (``tests/test_vi_slam.py``'s
``TestInertialLostGrace`` on the port): after IMU initialization, 1 s of
textureless frames leave the tracker RECENTLY_LOST on the IMU's prediction,
never LOST and without a relocalization attempt, and it re-acquires the
local map visually when texture returns. Bounds are that test's: every
blackout frame OK or RECENTLY_LOST, every frame from 42 on OK, no
relocalization during the grace, the distance travelled across the
blackout within 0.5 m of ground truth."""

import jax.numpy as jnp
import numpy as np

from orb_slam3_rgbl_tpu.config import IMU_RGBD
from orb_slam3_rgbl_tpu_torch.geometry import lie as t_lie
from orb_slam3_rgbl_tpu_torch.slam import tracking as t_trk

from test_torch_mono import _to_port
from test_torch_system import one_torch_thread  # noqa: F401  (module fixture)
from test_torch_vi_system import TSystem, convert, dataclasses, vi_frames

N_BLACKOUT = 50
BLACKOUT = set(range(30, 40))   # 1 s at 10 fps


def test_blackout_dead_reckoning():
    cfg, feats, blocks, gt, _ = vi_frames(IMU_RGBD, N_BLACKOUT)
    ts = TSystem(convert.config_from_dict(dataclasses.asdict(cfg)), device="cpu")
    states, poses, reloc_in_grace = [], [], [0]
    for i, f in enumerate(feats):
        if i in BLACKOUT:
            f = f._replace(valid=jnp.zeros_like(f.valid))
        if i == 1:
            tr, orig = ts.tracker, ts.tracker._relocalization

            def counting(fe, _orig=orig, _tr=tr):
                if _tr.state in (t_trk.RECENTLY_LOST, t_trk.LOST):
                    reloc_in_grace[0] += 1
                return _orig(fe)
            tr._relocalization = counting
        r = ts.track_features(_to_port(f), i * 0.1, imu=None if i == 0 else blocks[i - 1])
        states.append(r.state)
        poses.append(r.pose)
    assert ts.map.imu_initialized and states[29] == t_trk.OK
    assert all(states[i] in (t_trk.OK, t_trk.RECENTLY_LOST) for i in BLACKOUT), states
    assert t_trk.RECENTLY_LOST in states
    assert all(s == t_trk.OK for s in states[42:]), states[40:]
    assert reloc_in_grace[0] == 0
    c = t_lie.np_se3_centers(np.stack(poses))
    c_gt = t_lie.np_se3_centers(np.asarray(gt))
    d_est = np.linalg.norm(c[40] - c[29])
    d_gt = np.linalg.norm(c_gt[40] - c_gt[29])
    assert abs(d_est - d_gt) < 0.5, (d_est, d_gt)
