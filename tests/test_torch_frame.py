"""Port vs JAX: whole-frame feature extraction + LiDAR depth at the
synthetic configuration (320×192, 600 features, 4 levels) on a frame
rendered by the JAX package's synthetic world.

JAX runs with x64 off here, as the package runs outside the test suite:
with x64 on, ``jax.image.resize`` builds its weights in f64 and the
pyramid levels ≥ 1 move by up to 0.02."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_rgbl_tpu import synthetic as j_syn
from orb_slam3_rgbl_tpu.ops import depth as j_depth
from orb_slam3_rgbl_tpu.slam import frame as j_frame
from orb_slam3_rgbl_tpu_torch.slam import frame as t_frame


@pytest.fixture(scope="module")
def frames():
    cfg = j_syn.synthetic_rgbl_config()
    cam, lc = cfg.camera, cfg.lidar
    with jax.enable_x64(False):
        world = j_syn.make_world(0, tex_size=256)
        Twc = jnp.asarray(j_syn.straight_trajectory(3, step=0.6, weave=0.4)[2])
        img = np.array(j_syn.render_image(world, Twc, cam.fx, cam.fy, cam.cx, cam.cy,
                                          cam.height, cam.width))
        pts = np.array(j_syn.lidar_scan(world, Twc, n_az=256, n_el=48))
    K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]], np.float32)
    P = j_depth.lidar_projection_matrix(K, np.asarray(lc.T_velo_cam))
    kw = dict(n_features=600, n_levels=4)
    dkw = dict(min_dist=lc.min_dist, max_dist=lc.max_dist, method=lc.method,
               dil_kind=lc.dil_kernel_type, dil_ku=lc.dil_kernel_size_u, dil_kv=lc.dil_kernel_size_v)
    with jax.enable_x64(False):
        jf = j_frame.extract_features(jnp.asarray(img), cam.height, cam.width, **kw)
        jf, _ = j_frame.attach_lidar_depth(jf, jnp.asarray(pts), jnp.asarray(P), cam.height,
                                           cam.width, cam.bf, **dkw)
        jf = {k: np.asarray(v) for k, v in jf._asdict().items()}
    tf = t_frame.extract_features(img, cam.height, cam.width, device="cpu", **kw)
    tf, _ = t_frame.attach_lidar_depth(tf, torch.from_numpy(pts), torch.from_numpy(P),
                                       cam.height, cam.width, cam.bf, **dkw)
    tf = {k: v.numpy() for k, v in tf._asdict().items()}
    tf["desc"] = tf["desc"].view(np.uint32)
    return jf, tf


def test_level0_keypoints_exact(frames):
    jf, tf = frames
    lvl0 = jf["octave"] == 0
    assert lvl0.sum() > 100 and jf["valid"][lvl0].sum() > 100
    for k in ("uv", "response", "valid", "octave"):
        np.testing.assert_array_equal(tf[k][lvl0], jf[k][lvl0])


def test_whole_frame_features_agree(frames):
    jf, tf = frames
    v = jf["valid"]
    # keypoints and depth: levels ≥ 1 are resampled with the same f32
    # weights but rounded differently at ~2 ulp, which can move a corner
    # across a FAST threshold; allow 1% of slots to differ
    for k in ("uv", "valid", "octave", "depth", "u_right"):
        same = np.all((tf[k] == jf[k]).reshape(len(v), -1), axis=1)
        assert same.mean() >= 0.99, (k, same.mean())
    np.testing.assert_allclose(tf["response"], jf["response"], atol=1e-3)
    # angles: prefix sums added in another order (test_torch_brief) —
    # within 2e-3 rad on ≥ 99% of the valid slots
    dang = np.abs(np.angle(np.exp(1j * (tf["angle"].astype(np.float64) - jf["angle"]))))
    assert np.mean(dang[v] < 2e-3) >= 0.99
    # descriptors of valid keypoints: a tiny angle change flips a bit only
    # when a rotated sample sits at a rounding boundary; ≥ 97% identical
    # and the rest within 16 bits
    same = np.all(tf["desc"][v] == jf["desc"][v], axis=1)
    assert same.mean() >= 0.97, same.mean()
    bits = np.unpackbits((tf["desc"][v] ^ jf["desc"][v]).view(np.uint8), axis=1).sum(1)
    assert bits.max() <= 16, bits.max()
    # the depth path is exercised (the scan covers the lower image half)
    assert (jf["depth"][v] > 0).mean() > 0.3


@pytest.mark.parametrize("mode", ["continuous", "binned", "legacy"])
def test_extraction_equals_per_level_assembly(mode):
    """``extract_features`` (one multi-level K1 call, composite from K1)
    against the same frame assembled level by level: the one-level
    ``fast_and_blur`` on each level, ``brief_cuda.composite`` of its blurs,
    then the descriptors. Bit for bit in every BRIEF mode."""
    from orb_slam3_rgbl_tpu_torch.ops import brief_cuda, fast as t_fast, frontend_cuda
    from orb_slam3_rgbl_tpu_torch.ops import orb as t_orb, pyramid as t_pyr

    H, W, n_feat, n_lv = 96, 160, 200, 3
    img = torch.from_numpy(np.random.default_rng(3).uniform(0, 255, (H, W)).astype(np.float32))
    feats = t_frame.extract_features(img, H, W, n_features=n_feat, n_levels=n_lv,
                                     brief_mode=mode, device="cpu")
    levels = [lv.contiguous() for lv in t_pyr.build_pyramid(img, H, W, n_lv, 1.2)]
    budgets = t_fast.features_per_level(n_feat, n_lv, 1.2)
    uvs, angs, blurs, descs = [], [], [], []
    for lv, budget in zip(levels, budgets):
        score, blur = frontend_cuda.fast_and_blur(lv)
        uv, _, _ = t_fast.select_keypoints(score, budget, margin=19)
        uvs.append(uv)
        angs.append(t_orb.ic_angle(lv, uv))
        blurs.append(blur)
        descs.append(t_orb.brief_descriptors(blur, uv, angs[-1]))
    if mode != "legacy":
        descs = brief_cuda.descriptors_multilevel(*brief_cuda.composite(blurs), uvs, angs, mode=mode)
    assert feats.valid.sum() > 50
    assert torch.equal(feats.desc, torch.cat(descs))
    assert torch.equal(feats.angle, torch.cat(angs))
