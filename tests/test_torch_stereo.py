"""Port vs JAX: the stereo sensor — ``ops.matching.stereo_row_match``,
``slam.frame.attach_stereo_depth`` and ``refine_stereo_subpixel``, the
rectifier (``geometry/rectify.py``, which computes without OpenCV what the
JAX package asks OpenCV for) and ``System.track_stereo``.

The pair is the JAX package's canyon at 320×192, the right image rendered at
the left pose moved by the baseline bf / fx along the camera's x axis, both
rounded to integers as an 8-bit camera gives them. Both packages see the same
features (JAX's extraction, converted).

Tolerances:
* row matching: u_right and the best distances exact (integer Hamming
  distances, first-minimum argmin on both sides);
* ``attach_stereo_depth``: u_right exact, depth 1e-6 relative (bf / disparity
  in f32, observed equal);
* SAD refinement: the SAD table exact against a numpy loop (integer sums of
  ≤ 121 terms, exact in f32 in any order), u_right 1e-4 px, the same
  accepted mask; the median of the cut is JAX's ``nanmedian`` (the mean of the
  two middle values of an even count, where ``torch.nanmedian`` takes the
  lower);
* rectifier: maps 1e-3 px and the rectified camera 1e-4 relative against
  OpenCV's through the JAX package (observed equal to the bit), ``remap``
  1e-4 against ``remap_jax`` (observed 5e-5: f32 weights in another order)
  and 1e-2 inside a 5 px border against OpenCV's ``remap`` (the JAX test's
  bound);
* ``track_stereo`` over 14 frames with mapping and loop closing on: the same
  states and keyframes every frame, centres within 5 mm (observed 1.1 mm).

JAX runs with x64 off, as outside the test suite."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_rgbl_tpu import synthetic as j_syn
from orb_slam3_rgbl_tpu.config import STEREO, load_config as j_load_config
from orb_slam3_rgbl_tpu.geometry import rectify as j_rect
from orb_slam3_rgbl_tpu.ops import matching as j_match
from orb_slam3_rgbl_tpu.slam import frame as j_frame
from orb_slam3_rgbl_tpu.slam.system import System as JSystem
from orb_slam3_rgbl_tpu_torch import convert
from orb_slam3_rgbl_tpu_torch.config import load_config as t_load_config
from orb_slam3_rgbl_tpu_torch.geometry import lie as t_lie
from orb_slam3_rgbl_tpu_torch.geometry import rectify as t_rect
from orb_slam3_rgbl_tpu_torch.ops import matching as t_match
from orb_slam3_rgbl_tpu_torch.slam import frame as t_frame
from orb_slam3_rgbl_tpu_torch.slam import tracking as t_trk
from orb_slam3_rgbl_tpu_torch.slam.system import System as TSystem

from test_config import NEW_YAML
from test_torch_system import one_torch_thread  # noqa: F401  (module fixture)

N_DRIVE = 14
POSE_TOL_M = 5e-3


def stereo_config():
    return dataclasses.replace(j_syn.synthetic_rgbl_config(), sensor=STEREO)


def render_pairs(cfg, traj):
    """Left and right images (integer-valued f32) of each pose of ``traj``."""
    cam = cfg.camera
    base = np.array([cam.bf / cam.fx, 0.0, 0.0], np.float32)
    pairs = []
    with jax.enable_x64(False):
        world = j_syn.make_world(0, tex_size=256)
        for Twc in traj:
            Twc_r = np.array(Twc, np.float32)
            Twc_r[4:7] += t_lie.np_quat_rotate(Twc_r[:4], base)
            pairs.append(tuple(
                np.round(np.array(j_syn.render_image(world, jnp.asarray(T), cam.fx, cam.fy, cam.cx,
                                                     cam.cy, cam.height, cam.width)))
                for T in (Twc, Twc_r)))
    return pairs


def _to_port(f):
    return convert.frame_features_from_numpy({k: np.asarray(v) for k, v in f._asdict().items()},
                                             device="cpu")


@pytest.fixture(scope="module")
def pair():
    cfg = stereo_config()
    cam, o = cfg.camera, cfg.orb
    (left, right), = render_pairs(cfg, j_syn.straight_trajectory(1, step=0.6, weave=0.4))
    with jax.enable_x64(False):
        fl, fr = (j_frame.extract_features(jnp.asarray(im, jnp.float32), cam.height, cam.width,
                                           n_features=o.n_features, n_levels=o.n_levels,
                                           scale_factor=o.scale_factor)
                  for im in (left, right))
    return cfg, left.astype(np.float32), right.astype(np.float32), fl, fr


def test_stereo_row_match_exact(pair):
    cfg, _, _, fl, fr = pair
    o, cam = cfg.orb, cfg.camera
    sf = np.asarray([o.scale_factor ** l for l in range(o.n_levels)], np.float32)
    with jax.enable_x64(False):
        ur_j, d_j = j_match.stereo_row_match(
            fl.desc, fl.uv[:, 1], fl.valid, fl.octave, fr.desc, fr.uv[:, 0], fr.uv[:, 1],
            fr.valid, fr.octave, 0.0, cam.bf / 0.5, fl.uv[:, 0], jnp.asarray(sf))
    tl, tr = _to_port(fl), _to_port(fr)
    ur_t, d_t = t_match.stereo_row_match(
        tl.desc, tl.uv[:, 1], tl.valid, tr.desc, tr.uv[:, 0], tr.uv[:, 1], tr.valid,
        tr.octave, 0.0, cam.bf / 0.5, tl.uv[:, 0], torch.from_numpy(sf))
    np.testing.assert_array_equal(ur_t.numpy(), np.asarray(ur_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    assert (ur_t >= 0).sum() > 0.3 * int(tl.valid.sum())     # most valid features match


def _attach(pair):
    cfg, _, _, fl, fr = pair
    o, cam = cfg.orb, cfg.camera
    kw = dict(min_disp=0.0, max_disp=cam.bf / 0.5, n_levels=o.n_levels,
              scale_factor=o.scale_factor)
    with jax.enable_x64(False):
        fj = j_frame.attach_stereo_depth(fl, fr, cam.bf, **kw)
    ft = t_frame.attach_stereo_depth(_to_port(fl), _to_port(fr), cam.bf, **kw)
    return fj, ft


def test_attach_stereo_depth_matches_jax(pair):
    fj, ft = _attach(pair)
    np.testing.assert_array_equal(ft.u_right.numpy(), np.asarray(fj.u_right))
    np.testing.assert_allclose(ft.depth.numpy(), np.asarray(fj.depth), rtol=1e-6)
    has = ft.depth.numpy() > 0
    assert has.sum() > 100 and (ft.u_right.numpy()[~has] == -1).all()


def _sad_loop(uv, u_right, gl, gr, w=5, L=5):
    """The SAD table by a plain loop over keypoints and offsets (float64)."""
    H, W = gl.shape
    out = np.zeros((len(uv), 2 * L + 1))
    for i, ((u, v), ur) in enumerate(zip(uv, u_right)):
        vi = int(np.clip(np.round(v), w, H - w - 1))
        ui = int(np.clip(np.round(u), w, W - w - 1))
        c = int(np.clip(np.round(ur), w + L, W - w - L - 1))
        patch = gl[vi - w: vi + w + 1, ui - w: ui + w + 1].astype(np.float64)
        for k, off in enumerate(range(-L, L + 1)):
            win = gr[vi - w: vi + w + 1, c + off - w: c + off + w + 1]
            out[i, k] = np.abs(patch - win).sum()
    return out


def test_refine_stereo_subpixel_matches_jax(pair):
    cfg, left, right, _, _ = pair
    fj, ft = _attach(pair)
    table, _ = t_frame.stereo_sad_table(ft, torch.from_numpy(left), torch.from_numpy(right))
    has = ft.u_right.numpy() >= 0
    ref = _sad_loop(ft.uv.numpy()[has], ft.u_right.numpy()[has], left, right)
    np.testing.assert_array_equal(table.numpy()[has], ref)
    bf = cfg.camera.bf
    with jax.enable_x64(False):
        rj = j_frame.refine_stereo_subpixel(fj, jnp.asarray(left), jnp.asarray(right), bf)
    rt = t_frame.refine_stereo_subpixel(ft, torch.from_numpy(left), torch.from_numpy(right), bf)
    moved_j = np.asarray(rj.u_right) != np.asarray(fj.u_right)
    moved_t = rt.u_right.numpy() != ft.u_right.numpy()
    np.testing.assert_array_equal(moved_t, moved_j)
    assert moved_t.sum() > 0.5 * has.sum()
    np.testing.assert_allclose(rt.u_right.numpy(), np.asarray(rj.u_right), atol=1e-4)
    np.testing.assert_allclose(rt.depth.numpy(), np.asarray(rj.depth), rtol=1e-4)


def test_refinement_median_is_the_mean_of_the_middle_pair(pair):
    """With an even count of accepted matches the cut's median is the mean of
    the two middle SADs (``jnp.nanmedian``); ``torch.nanmedian`` would take
    the lower one. Both the median alone and a whole refinement with an even
    count are held to JAX."""
    rng = np.random.default_rng(3)
    for n in (1, 2, 7, 8, 64, 65):
        v = rng.integers(0, 3000, 100).astype(np.float32)
        keep = np.zeros(100, bool)
        keep[rng.choice(100, n, replace=False)] = True
        med_t = t_frame._nanmedian_of(torch.from_numpy(v), torch.from_numpy(keep))
        with jax.enable_x64(False):
            med_j = jnp.nanmedian(jnp.where(jnp.asarray(keep), jnp.asarray(v), jnp.nan))
        assert float(med_t) == float(med_j), (n, float(med_t), float(med_j))
        if n % 2 == 0:
            assert float(torch.nanmedian(torch.from_numpy(np.where(keep, v, np.nan)))) < float(med_j)
    assert float(t_frame._nanmedian_of(torch.ones(4), torch.zeros(4, dtype=torch.bool))) == np.inf
    # a whole refinement whose accepted count is even, one match dropped if need be
    cfg, left, right, _, _ = pair
    fj, ft = _attach(pair)
    bf = cfg.camera.bf
    rt = t_frame.refine_stereo_subpixel(ft, torch.from_numpy(left), torch.from_numpy(right), bf)
    moved = np.nonzero(rt.u_right.numpy() != ft.u_right.numpy())[0]
    ur = np.asarray(fj.u_right).copy()
    if moved.size % 2:
        ur[moved[0]] = -1.0
    fj = fj._replace(u_right=jnp.asarray(ur))
    ft = ft._replace(u_right=torch.from_numpy(ur))
    with jax.enable_x64(False):
        rj = j_frame.refine_stereo_subpixel(fj, jnp.asarray(left), jnp.asarray(right), bf)
    rt = t_frame.refine_stereo_subpixel(ft, torch.from_numpy(left), torch.from_numpy(right), bf)
    np.testing.assert_array_equal(rt.u_right.numpy() != ur, np.asarray(rj.u_right) != ur)
    np.testing.assert_allclose(rt.u_right.numpy(), np.asarray(rj.u_right), atol=1e-4)


@pytest.fixture
def settings(tmp_path):
    p = tmp_path / "stereo.yaml"
    p.write_text(NEW_YAML)
    return str(p)


def test_rectifier_matches_opencv_through_jax(settings):
    rj = j_rect.build_rectifier(j_load_config(settings, sensor=STEREO))
    rt = t_rect.build_rectifier(t_load_config(settings, sensor=STEREO))
    assert rt.map_l.shape == (480, 752, 2) and rt.map_l.dtype == np.float32
    np.testing.assert_allclose(rt.map_l, rj.map_l, atol=1e-3)
    np.testing.assert_allclose(rt.map_r, rj.map_r, atol=1e-3)
    cj, ct = rj.cam_rect, rt.cam_rect
    for k in ("fx", "fy", "cx", "cy", "bf"):
        assert getattr(ct, k) == pytest.approx(getattr(cj, k), rel=1e-4), k
    assert not ct.has_distortion
    assert ct.bf / ct.fx == pytest.approx(0.11008, abs=1e-3)


def test_rectifier_of_a_turned_right_camera(settings):
    """The right camera turned by 0.5° about y and a baseline along x with a
    small vertical offset (the case ``chip_smoke.py`` phase 12 drives):
    maps and rectified camera against OpenCV's."""
    cfg_j = j_load_config(settings, sensor=STEREO)
    c, s = np.cos(np.deg2rad(0.5)), np.sin(np.deg2rad(0.5))
    T = np.array([[c, 0, s, 0.3], [0, 1, 0, 0.004], [-s, 0, c, 0.002], [0, 0, 0, 1.0]])
    st = dataclasses.replace(cfg_j.stereo, T_c1_c2=tuple(T.reshape(-1).tolist()))
    rj = j_rect.build_rectifier(dataclasses.replace(cfg_j, stereo=st))
    cfg_t = t_load_config(settings, sensor=STEREO)
    rt = t_rect.build_rectifier(dataclasses.replace(
        cfg_t, stereo=dataclasses.replace(cfg_t.stereo, T_c1_c2=st.T_c1_c2)))
    np.testing.assert_allclose(rt.map_l, rj.map_l, atol=1e-3)
    np.testing.assert_allclose(rt.map_r, rj.map_r, atol=1e-3)
    assert rt.cam_rect.bf == pytest.approx(rj.cam_rect.bf, rel=1e-4)
    assert rt.cam_rect.cx == pytest.approx(rj.cam_rect.cx, rel=1e-4)


def test_remap_matches_remap_jax_and_opencv(settings):
    rj = j_rect.build_rectifier(j_load_config(settings, sensor=STEREO))
    rt = t_rect.build_rectifier(t_load_config(settings, sensor=STEREO))
    rng = np.random.default_rng(0)
    img_l = rng.uniform(0, 255, (480, 752)).astype(np.float32)
    img_r = rng.uniform(0, 255, (480, 752)).astype(np.float32)
    with jax.enable_x64(False):
        jl, jr = (np.asarray(a) for a in rj.remap_jax(img_l, img_r))
    cl, cr = rj.remap(img_l, img_r)
    tl, tr = (a.numpy() for a in rt.remap(torch.from_numpy(img_l), torch.from_numpy(img_r)))
    np.testing.assert_allclose(tl, jl, atol=1e-4)
    np.testing.assert_allclose(tr, jr, atol=1e-4)
    assert np.abs(tl[5:-5, 5:-5] - cl[5:-5, 5:-5]).max() < 1e-2
    assert np.abs(tr[5:-5, 5:-5] - cr[5:-5, 5:-5]).max() < 1e-2


def test_system_rectifies_a_camera2_configuration(settings):
    """STEREO with a ``Camera2`` section that needs rectifying: both Systems
    build the rectifier and work on the same rectified camera."""
    js = JSystem(j_load_config(settings, sensor=STEREO))
    ts = TSystem(t_load_config(settings, sensor=STEREO), device="cpu")
    assert js.rectifier is not None and ts.rectifier is not None
    for k in ("fx", "fy", "cx", "cy", "bf", "k1"):
        assert getattr(ts.cam, k) == pytest.approx(getattr(js.cam, k), rel=1e-4), k
    assert ts._undistort_cam is None


def test_track_stereo_drive_matches_jax():
    """Both Systems (mapping and loop closing on) over 14 stereo frames of
    the canyon: the same states and keyframes every frame, centres within
    5 mm, every frame on the per-stage path (no fused stereo step)."""
    cfg = stereo_config()
    traj = j_syn.straight_trajectory(N_DRIVE, step=0.6, weave=0.4)
    pairs = render_pairs(cfg, traj)
    js = JSystem(cfg)
    ts = TSystem(convert.config_from_dict(dataclasses.asdict(cfg)), device="cpu")
    cj, ct = [], []
    with jax.enable_x64(False):
        for i, (left, right) in enumerate(pairs):
            rj = js.track_stereo(left, right, i * 0.1)
            rt = ts.track_stereo(left, right, i * 0.1)
            assert rj.state == rt.state == t_trk.OK, i
            assert rj.created_kf == rt.created_kf and js.map.n_kf == ts.map.n_kf, i
            cj.append(t_lie.np_se3_centers(rj.pose))
            ct.append(t_lie.np_se3_centers(rt.pose))
    assert ts.map.n_kf >= 2 and ts._fast is None
    assert np.abs(np.stack(ct) - np.stack(cj)).max() < POSE_TOL_M
    err = np.linalg.norm(np.stack(ct) - (traj[:, 4:7] - traj[0, 4:7]), axis=1)
    assert err.max() < 0.2, err.max()
