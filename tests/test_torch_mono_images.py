"""Port vs JAX: both Systems with the MONOCULAR sensor over
``tests/test_image_e2e.py::TestMonoFusedPath``'s image drive through
``track_monocular`` (mapping and loop closing on): two-view initialization
on the classic ladder, then the fused step without a depth source.

Tolerances (30 frames at 320×192): each package initializes by frame 12
(``tests/test_mono.py``'s bound; the frame itself may differ by one: the
two RANSACs draw from different streams and the reference frame's parallax
is marginal — JAX initialized on frame 3 and the port on frame 4 in the
run that set this), the port takes the fused step on every frame from the
second after its initialization, > 80% of the frames OK and Sim3-aligned
ATE < 0.4 each (``tests/test_image_e2e.py``'s bounds, in the map's units: that
test aligns the ground truth to the estimate).

JAX runs with x64 off, as outside the test suite."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp

from orb_slam3_rgbl_tpu import synthetic as j_syn
from orb_slam3_rgbl_tpu.config import MONOCULAR
from orb_slam3_rgbl_tpu.slam.system import System as JSystem
from orb_slam3_rgbl_tpu_torch import convert
from orb_slam3_rgbl_tpu_torch.slam import tracking as t_trk
from orb_slam3_rgbl_tpu_torch.slam.system import System as TSystem

from test_torch_mono_drive import _sim3_ate
from test_torch_system import one_torch_thread  # noqa: F401  (module fixture)

N_IMAGES = 30


def test_track_monocular_image_drive_matches_jax():
    """``tests/test_image_e2e.py::TestMonoFusedPath`` on both packages: the
    weave gives the two-view parallax; steady frames run the fused step."""
    cfg = dataclasses.replace(j_syn.synthetic_rgbl_config(), sensor=MONOCULAR)
    cam = cfg.camera
    traj = j_syn.straight_trajectory(N_IMAGES, step=0.5, weave=1.2)
    js = JSystem(cfg)
    ts = TSystem(convert.config_from_dict(dataclasses.asdict(cfg)), device="cpu")
    fused = []
    accept = t_trk.Tracker._accept_fused

    def counted(self, *a, **k):
        fused[-1] = True
        return accept(self, *a, **k)

    t_trk.Tracker._accept_fused = counted
    states_j, states_t = [], []
    try:
        with jax.enable_x64(False):
            world = j_syn.make_world(0, tex_size=256)
            for i, Twc in enumerate(traj):
                img = np.array(j_syn.render_image(world, jnp.asarray(Twc), cam.fx, cam.fy,
                                                  cam.cx, cam.cy, cam.height, cam.width))
                fused.append(False)
                states_j.append(js.track_monocular(img, i * 0.1).state)
                states_t.append(ts.track_monocular(img, i * 0.1).state)
    finally:
        t_trk.Tracker._accept_fused = accept
    init_j, init_t = states_j.index(t_trk.OK), states_t.index(t_trk.OK)
    assert max(init_j, init_t) <= 12, (states_j, states_t)
    assert all(fused[init_t + 2:]), [i for i, f in enumerate(fused) if f]
    assert not any(fused[: init_t + 1])
    assert ts._fast is not None and ts._fast.mode == "mono"
    gt = traj - np.concatenate([np.zeros(4), traj[0, 4:7]])[None]
    for states, s in ((states_j, js), (states_t, ts)):
        assert np.mean([st == t_trk.OK for st in states]) > 0.8, states
        est = s.trajectory()
        # the argument order of tests/test_image_e2e.py: the estimate is the
        # model, so the error is in the map's units
        assert _sim3_ate(est, gt, np.ones(len(est), bool)) < 0.4
