"""Port vs JAX: both Systems with the MONOCULAR sensor (mapping and loop
closing on) over ``tests/test_mono.py``'s feature-level drive through
``track_features``. The two initializations draw different minimal sets
(each package its own stream), so the maps differ at the f32 noise of the
solve, in a map of unit median depth. The image drive through
``track_monocular`` is in test_torch_mono_images.py.

Tolerances (24 frames): initialization on the same frame, every frame OK
after it (``tests/test_mono.py``'s bound: the first OK frame ≤ 12), the
same keyframe counts, centres within 5e-3 map units (observed 4.4e-4 after
20 frames), Sim3-aligned ATE < 1 m each (that test's bound).

JAX runs with x64 off, as outside the test suite."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from orb_slam3_rgbl_tpu.geometry import align as j_align, lie as j_lie
from orb_slam3_rgbl_tpu.slam.system import System as JSystem
from orb_slam3_rgbl_tpu_torch import convert
from orb_slam3_rgbl_tpu_torch.geometry import lie as t_lie
from orb_slam3_rgbl_tpu_torch.slam import tracking as t_trk
from orb_slam3_rgbl_tpu_torch.slam.system import System as TSystem

from test_torch_mono import _mono_frames, _to_port
from test_torch_system import one_torch_thread  # noqa: F401  (module fixture)

N_MONO = 24


def _sim3_ate(gt_twc, est, sel) -> float:
    with jax.enable_x64(False):
        return float(j_align.ate_rmse(jnp.asarray(gt_twc[sel, 4:7]),
                                      jnp.asarray(np.asarray(est)[sel, 4:7]), with_scale=True))


def test_run_mono_matches_jax():
    """``tests/test_mono.py``'s drive on both packages."""
    cfg, feats, gt = _mono_frames(N_MONO)
    js = JSystem(cfg)
    ts = TSystem(convert.config_from_dict(dataclasses.asdict(cfg)), device="cpu")
    log = []
    with jax.enable_x64(False):
        for i, f in enumerate(feats):
            rj = js.track_features(f, i * 0.1)
            rt = ts.track_features(_to_port(f), i * 0.1)
            log.append((rj, rt, js.map.n_kf if js.map else 0, ts.map.n_kf if ts.map else 0))
    states_t = [r[1].state for r in log]
    assert states_t == [r[0].state for r in log]
    first_ok = states_t.index(t_trk.OK)
    assert first_ok <= 12 and all(s == t_trk.OK for s in states_t[first_ok:])
    assert [r[2] for r in log] == [r[3] for r in log]
    assert ts.map.n_kf >= 3 and ts.map.n_lm > 300
    assert ts.loop_closer.fix_scale is False and js.loop_closer.fix_scale is False
    c_j = t_lie.np_se3_centers(np.stack([r[0].pose for r in log[first_ok:]]))
    c_t = t_lie.np_se3_centers(np.stack([r[1].pose for r in log[first_ok:]]))
    assert np.abs(c_t - c_j).max() < 5e-3, np.abs(c_t - c_j).max()
    gt_twc = np.asarray(j_lie.se3_inv(jnp.asarray(gt)))
    for s in (js, ts):
        assert _sim3_ate(gt_twc, s.trajectory(), ~np.array(s.tracker.traj_lost)) < 1.0
