"""Port vs JAX: the binned rBRIEF module (K3's path) of
``ops/brief_cuda`` against ``orb_slam3_rgbl_tpu.ops.brief_pallas``, the
Pallas kernel in interpret mode, and whole-frame extraction in the
'binned' and 'legacy' BRIEF modes.

Given the same angles, tables, layout and descriptors are bit-exact: the
arithmetic is integer or the same f32 operations in the same order. The
frame-level test compares to test_torch_frame.py's match fractions,
because the IC angles of the two packages differ by up to 2e-3 rad
(test_torch_brief)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_rgbl_tpu import synthetic as j_syn
from orb_slam3_rgbl_tpu.ops import brief_pallas as bp
from orb_slam3_rgbl_tpu.slam import frame as j_frame
from orb_slam3_rgbl_tpu_torch.ops import brief_cuda as bc
from orb_slam3_rgbl_tpu_torch.slam import frame as t_frame


def _setup(rng, H=256, W=512, N=70):
    """The inputs of tests/test_brief_pallas.py: a rounded random image,
    keypoints ≥ 20 px inside it, uniform angles."""
    img = np.round(rng.uniform(0, 255, (H, W))).astype(np.float32)
    uv = np.stack([rng.integers(20, W - 160, N), rng.integers(20, H - 28, N)], 1).astype(np.int32)
    ang = rng.uniform(-np.pi, np.pi, N).astype(np.float32)
    return img, uv, ang


def test_constants_and_pattern_tables():
    assert (bc.NB, bc.BLK, bc.HALF, bc.PATCH) == (bp.NB, bp.BLK, bp.HALF, bp.PATCH)
    np.testing.assert_array_equal(bc.binned_pattern_tables(), bp.binned_pattern_tables())


def test_angle_bins_exact_on_random_angles_and_bin_edges():
    rng = np.random.default_rng(3)
    edges = (-np.pi + np.arange(bp.NB + 1) * 2 * np.pi / bp.NB).astype(np.float32)
    near = np.concatenate([edges, np.nextafter(edges, np.float32(-10)),
                           np.nextafter(edges, np.float32(10))])
    ang = np.concatenate([rng.uniform(-np.pi, np.pi, 4096).astype(np.float32), near,
                          np.float32([-4.0, 4.0, 0.0])])
    with jax.enable_x64(False):
        ref = np.asarray(bp.angle_bins(jnp.asarray(ang)))
    out = bc.angle_bins(torch.from_numpy(ang)).numpy()
    np.testing.assert_array_equal(out, ref)
    assert out.dtype == np.int32 and set(np.unique(out)) == set(range(bp.NB))


@pytest.mark.parametrize("n", [1, 70, 500, 2000])
def test_slot_capacity_and_bin_pure_layout_exact(n):
    rng = np.random.default_rng(n)
    # skewed bins, as IC angles are on a street scene, and a few empty ones
    bins = np.minimum(rng.geometric(0.15, n) - 1, bp.NB - 3).astype(np.int32)
    S = bp.slot_capacity(n)
    assert bc.slot_capacity(n) == S
    with jax.enable_x64(False):
        slots_j, bb_j = bp.bin_pure_layout(jnp.asarray(bins), S)
    slots_t, bb_t = bc.bin_pure_layout(torch.from_numpy(bins), S)
    np.testing.assert_array_equal(slots_t.numpy(), np.asarray(slots_j))
    np.testing.assert_array_equal(bb_t.numpy(), np.asarray(bb_j))
    assert slots_t.dtype == bb_t.dtype == torch.int32 and tuple(bb_t.shape) == (S // bp.BLK, 1)


def test_binned_gather_form_matches_brief_binned_ref(rng):
    img, uv, ang = _setup(rng)
    with jax.enable_x64(False):
        ref = np.asarray(bp.brief_binned_ref(jnp.asarray(img), jnp.asarray(uv), jnp.asarray(ang)))
    out = bc.brief_binned_plain(torch.from_numpy(img), torch.from_numpy(uv), torch.from_numpy(ang))
    np.testing.assert_array_equal(out.numpy().view(np.uint32), ref)


def test_k3_plain_version_matches_the_pallas_kernel(rng):
    """``brief_blocks_plain`` on K3's exact inputs against
    ``brief_blocks_pallas(interpret=True)``: bit-exact on the real slots
    (and, with padding corners at (1, 1), on every slot)."""
    img, uv, ang = _setup(rng)
    S = bp.slot_capacity(uv.shape[0])
    with jax.enable_x64(False):
        slots, block_bins = bp.bin_pure_layout(bp.angle_bins(jnp.asarray(ang)), S)
        corners = jnp.ones((S, 2), jnp.int32).at[slots].set(jnp.asarray(uv) - bp.HALF)
        ref = np.asarray(bp.brief_blocks_pallas(jnp.asarray(img), corners, block_bins,
                                                interpret=True))
    out = bc.brief_blocks(torch.from_numpy(img), torch.from_numpy(np.array(corners)),
                          torch.from_numpy(np.array(block_bins))).numpy().view(np.uint32)
    slots = np.asarray(slots)
    np.testing.assert_array_equal(out[slots], ref[slots])
    np.testing.assert_array_equal(out, ref)


def test_descriptors_multilevel_binned_matches_jax(rng):
    """The whole binned path over two levels (composite, layout, K3's
    plain version, un-slotting) against both JAX paths on the same angles:
    the CPU reference and the Pallas orchestrator in interpret mode."""
    img, uv, ang = _setup(rng)
    lvl1 = np.round(rng.uniform(0, 255, (128, 256))).astype(np.float32)
    uv2 = np.stack([rng.integers(20, 236, 30), rng.integers(20, 108, 30)], 1).astype(np.int32)
    ang2 = rng.uniform(-np.pi, np.pi, 30).astype(np.float32)
    j_args = ([jnp.asarray(img), jnp.asarray(lvl1)], [jnp.asarray(uv), jnp.asarray(uv2)],
              [jnp.asarray(ang), jnp.asarray(ang2)])
    with jax.enable_x64(False):
        d_ref = bp.descriptors_multilevel(*j_args, use_pallas=False, mode="binned")
        d_pal = bp.descriptors_multilevel(*j_args, use_pallas=True, interpret=True, mode="binned")
    comp, offs = bc.composite([torch.from_numpy(img), torch.from_numpy(lvl1)])
    d_t = bc.descriptors_multilevel(comp, offs,
                                    [torch.from_numpy(uv), torch.from_numpy(uv2)],
                                    [torch.from_numpy(ang), torch.from_numpy(ang2)], mode="binned")
    for t, r, p in zip(d_t, d_ref, d_pal):
        np.testing.assert_array_equal(t.numpy().view(np.uint32), np.asarray(r))
        np.testing.assert_array_equal(t.numpy().view(np.uint32), np.asarray(p))
    with pytest.raises(ValueError, match="unknown mode"):
        bc.descriptors_multilevel(*bc.composite([torch.from_numpy(img)]), [torch.from_numpy(uv)],
                                  [torch.from_numpy(ang)], mode="bogus")


@pytest.fixture(scope="module")
def frame_img():
    cfg = j_syn.synthetic_rgbl_config()
    cam = cfg.camera
    with jax.enable_x64(False):
        world = j_syn.make_world(0, tex_size=256)
        Twc = jnp.asarray(j_syn.straight_trajectory(3, step=0.6, weave=0.4)[2])
        img = np.array(j_syn.render_image(world, Twc, cam.fx, cam.fy, cam.cx, cam.cy,
                                          cam.height, cam.width))
    return cam, img


@pytest.mark.parametrize("mode", ["binned", "legacy"])
def test_extract_features_brief_modes_match_jax(frame_img, mode):
    """Whole-frame extraction in the two other BRIEF modes at the
    synthetic configuration (320×192, 600 features, 4 levels), to
    test_torch_frame.py's fractions: keypoints on ≥ 99% of slots, ≥ 97%
    of valid descriptors identical and the rest within 16 bits (an IC
    angle 2e-3 rad off can move a keypoint into the next bin or flip a
    rounded sample)."""
    cam, img = frame_img
    kw = dict(n_features=600, n_levels=4, brief_mode=mode)
    with jax.enable_x64(False):
        jf = j_frame.extract_features(jnp.asarray(img), cam.height, cam.width, **kw)
        jf = {k: np.asarray(v) for k, v in jf._asdict().items()}
    tf = t_frame.extract_features(img, cam.height, cam.width, device="cpu", **kw)
    tf = {k: v.numpy() for k, v in tf._asdict().items()}
    v = jf["valid"]
    for k in ("uv", "valid", "octave"):
        same = np.all((tf[k] == jf[k]).reshape(len(v), -1), axis=1)
        assert same.mean() >= 0.99, (k, same.mean())
    desc_t = tf["desc"].view(np.uint32)
    same = np.all(desc_t[v] == jf["desc"][v], axis=1)
    assert same.mean() >= 0.97, same.mean()
    bits = np.unpackbits((desc_t[v] ^ jf["desc"][v]).view(np.uint8), axis=1).sum(1)
    assert bits.max() <= 16, bits.max()


def test_extract_features_rejects_unknown_mode():
    with pytest.raises(ValueError, match="brief_mode"):
        t_frame.extract_features(torch.zeros(64, 64), 64, 64, n_levels=1, brief_mode="fast",
                                 device="cpu")
