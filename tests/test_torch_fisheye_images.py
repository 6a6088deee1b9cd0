"""Port vs JAX: ``System.track_stereo`` on an unrectified stereo-fisheye
pair: 12 pairs at 512×512 of the JAX package's box room, rendered here by
casting KB8 rays (``kb8_unproject``) through the synthetic world's ray
caster and shader, the right camera 0.101 m to the side and turned by 0.5°
(``Stereo.T_c1_c2``), the TUM-VI-like fisheye of ``tests/test_fisheye_e2e.py``.
No rectifier is built; each frame's depth comes from
``attach_stereo_fisheye_depth``.

Tolerances: the same states and keyframes every frame, centres within
5 mm of JAX's, the share of left keypoints with a fisheye depth within 2%
of JAX's (the triangulation's gates may flip a flag between the libraries,
tests/test_torch_kb8.py), and test_torch_stereo's 0.2 m bar against the
ground truth. JAX runs with x64 off, as outside the test suite."""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp

from orb_slam3_rgbl_tpu import synthetic as j_syn
from orb_slam3_rgbl_tpu.config import StereoConfig
from orb_slam3_rgbl_tpu.geometry import camera as jcam, lie as jlie
from orb_slam3_rgbl_tpu.slam.system import System as JSystem
from orb_slam3_rgbl_tpu_torch.geometry import lie as tlie
from orb_slam3_rgbl_tpu_torch.slam import tracking as t_trk

import test_fisheye_e2e as jf
from test_torch_fisheye_e2e import POSE_TOL_M, _port_system
from test_torch_system import one_torch_thread  # noqa: F401  (module fixture)

N_IMAGE = 12
RIGHT_TURN_DEG = 0.5
# an indoor room, as TUM-VI's: over the 0.101 m baseline the triangulation's
# parallax gate (cos < 0.9998, 1.15°) passes points closer than ~5 m. Near
# the gate both packages' f32 DLT (eigh of AᵀA) moves a depth by up to 2.4%
# (1/sin² of the parallax), differently in each library: in a 2.5 m room
# the two Systems' maps then parted at a keyframe decision on frame 9 (a
# chaotic split, ROADMAP Queue 3); in this 2 m room they stay within 2.4 mm
# over the 12 frames
ROOM_HALF = 2.0


def _stereo_fisheye_config():
    """fisheye_config with a second KB8 camera 0.101 m to the right, turned
    by RIGHT_TURN_DEG about its y axis (an unrectified pair)."""
    cfg = jf.fisheye_config()
    a = np.deg2rad(RIGHT_TURN_DEG)
    T = np.eye(4)
    T[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    T[0, 3] = jf.BASELINE
    c = cfg.camera
    st = StereoConfig(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy, k1=c.k1, k2=c.k2, k3=c.k3, p2=c.p2,
                      T_c1_c2=tuple(T.reshape(-1).tolist()), needs_rectify=True)
    return dataclasses.replace(cfg, stereo=st, loop_closing=True), T


@functools.partial(jax.jit, static_argnames=("cam",))
def render_kb8(world, Twc, cam):
    """(H, W) view of ``world`` from Twc through the KB8 camera ``cam``, a
    ray a pixel: ``kb8_unproject``'s bearing, turned back where the pixel
    sees past 90° (there tan(θ) < 0 mirrors the bearing)."""
    H, W = cam.height, cam.width
    u, v = jnp.meshgrid(jnp.arange(W, dtype=jnp.float32) + 0.5,
                        jnp.arange(H, dtype=jnp.float32) + 0.5)
    rays = jcam.kb8_unproject(cam, jnp.stack([u, v], -1))
    d = jnp.sqrt(((u - cam.cx) / cam.fx) ** 2 + ((v - cam.cy) / cam.fy) ** 2)
    t2 = (np.pi / 2) ** 2
    d90 = np.pi / 2 * (1 + t2 * (cam.k0 + t2 * (cam.k1 + t2 * (cam.k2 + t2 * cam.k3))))
    rays = jnp.where((d > d90)[..., None], -rays, rays)
    Twc = jnp.asarray(Twc)
    d_w = jnp.einsum("ij,hwj->hwi", jlie.quat_to_matrix(Twc[:4]), rays)
    o = jnp.broadcast_to(Twc[4:7], d_w.shape)
    t, plane, hit = j_syn._cast(world, o, d_w)
    X = o + jnp.where(hit, t, 0.0)[..., None] * d_w
    return jnp.round(jnp.where(hit, j_syn._shade(world, X, plane), 0.0))


def _image_pairs(cfg, T12):
    cam_l = cfg.geo_camera
    st = cfg.stereo
    cam_r = dataclasses.replace(cam_l, fx=st.fx, fy=st.fy, cx=st.cx, cy=st.cy)
    with jax.enable_x64(False):
        world = j_syn.make_box_world(3, tex_size=256, half=ROOM_HALF)
        traj = j_syn.straight_trajectory(N_IMAGE, step=0.1, yaw_rate=0.03, weave=0.1)
        traj[:, 6] -= 0.5
        q12 = np.asarray(jlie.matrix_to_quat(jnp.asarray(T12[:3, :3], jnp.float32)))
        T12_7 = np.concatenate([q12, T12[:3, 3]]).astype(np.float32)
        pairs = []
        for Twc in traj:
            Twc_r = np.asarray(jlie.se3_mul(jnp.asarray(Twc), jnp.asarray(T12_7)))
            pairs.append((np.asarray(render_kb8(world, Twc, cam_l)),
                          np.asarray(render_kb8(world, Twc_r, cam_r))))
    return traj, pairs


def _depth_shares(monkeypatch, frame_module, shares: list):
    """Record, per call of the module's ``attach_stereo_fisheye_depth``, the
    share of valid left keypoints that got a depth."""
    orig = frame_module.attach_stereo_fisheye_depth

    def spy(feats_l, *a, **k):
        out = orig(feats_l, *a, **k)
        valid = np.asarray(feats_l.valid)
        shares.append(float((np.asarray(out.depth)[valid] > 0).mean()))
        return out

    monkeypatch.setattr(frame_module, "attach_stereo_fisheye_depth", spy)


def test_track_stereo_fisheye_images_match_jax(monkeypatch):
    from orb_slam3_rgbl_tpu.slam import frame as jframe
    from orb_slam3_rgbl_tpu_torch.slam import frame as tframe

    cfg, T12 = _stereo_fisheye_config()
    traj, pairs = _image_pairs(cfg, T12)
    js, ts = JSystem(cfg), _port_system(cfg)
    assert js.rectifier is None and ts.rectifier is None
    share_j, share_t = [], []
    _depth_shares(monkeypatch, jframe, share_j)
    _depth_shares(monkeypatch, tframe, share_t)
    cj, ct = [], []
    with jax.enable_x64(False):
        for i, (left, right) in enumerate(pairs):
            rj = js.track_stereo(left, right, i * 0.05)
            rt = ts.track_stereo(left, right, i * 0.05)
            assert rj.state == rt.state == t_trk.OK, i
            assert rj.created_kf == rt.created_kf and js.map.n_kf == ts.map.n_kf, i
            cj.append(tlie.np_se3_centers(rj.pose))
            ct.append(tlie.np_se3_centers(rt.pose))
    assert ts.map.n_kf >= 2 and ts._fast is None
    diff = np.abs(np.stack(ct) - np.stack(cj)).max()
    assert diff < POSE_TOL_M, diff
    # test_torch_stereo's bar on its drive (0.124 m seen in a 5 m room: over
    # the 0.101 m baseline at fx 190 a 0.7 px match error is ~10% of a depth
    # at 2.5 m)
    err = np.linalg.norm(np.stack(ct) - (traj[:, 4:7] - traj[0, 4:7]), axis=1)
    assert err.max() < 0.2, err.max()
    # every frame went through the triangulation, which gave depth to a
    # share of the left keypoints within 2% of JAX's
    assert len(share_t) == len(share_j) == N_IMAGE
    assert np.abs(np.asarray(share_t) - share_j).max() < 0.02, (share_t, share_j)
    assert min(share_t) > 0.15, share_t
