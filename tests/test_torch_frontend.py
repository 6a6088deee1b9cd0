"""Port vs JAX: pyramid, FAST, keypoint selection and the fused frontend
(K1's plain version, and the Pallas kernel in interpret mode).

Inputs are made with ``numpy.random.default_rng`` and handed to both
packages as f32 numpy arrays; JAX runs on the CPU."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_rgbl_tpu.ops import brief_pallas as j_bp
from orb_slam3_rgbl_tpu.ops import fast as j_fast
from orb_slam3_rgbl_tpu.ops import frontend_pallas as j_frontend
from orb_slam3_rgbl_tpu.ops import pyramid as j_pyr
from orb_slam3_rgbl_tpu_torch.ops import brief_cuda as t_bp
from orb_slam3_rgbl_tpu_torch.ops import fast as t_fast
from orb_slam3_rgbl_tpu_torch.ops import frontend_cuda as t_frontend
from orb_slam3_rgbl_tpu_torch.ops import pyramid as t_pyr


def _int_image(rng, h, w):
    # integer intensities: FAST contrasts tie constantly
    return np.round(rng.uniform(0, 255, (h, w))).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_fast_score_exact_on_integer_images(rng):
    img = _int_image(rng, 96, 160)
    ref = np.asarray(j_fast.fast_score(jnp.asarray(img)))
    out = t_fast.fast_score(_t(img)).numpy()
    np.testing.assert_array_equal(out, ref)


def test_nms_and_selection_exact_including_invalid_slots(rng):
    # blocky integer image: many equal scores, cells both above ini_th and
    # only above min_th, and empty cells (invalid output slots)
    img = np.kron(_int_image(rng, 40, 64), np.ones((3, 3), np.float32))[:112, :176]
    img[:, 100:] = np.round(img[:, 100:] / 16.0)
    score = t_fast.fast_score(_t(img))
    np.testing.assert_array_equal(
        t_fast.nms3(score).numpy(), np.asarray(j_fast.nms3(jnp.asarray(score.numpy()))))
    for n_out in (150, 400):
        uv_j, resp_j, valid_j = (np.asarray(a) for a in j_fast.select_keypoints(
            jnp.asarray(score.numpy()), n_out, margin=19))
        uv_t, resp_t, valid_t = t_fast.select_keypoints(score, n_out, margin=19)
        assert not valid_j.all()       # the invalid slots are exercised
        np.testing.assert_array_equal(uv_t.numpy(), uv_j)
        np.testing.assert_array_equal(resp_t.numpy(), resp_j)
        np.testing.assert_array_equal(valid_t.numpy(), valid_j)


def test_features_per_level_and_level_sizes():
    for args in ((2000, 8, 1.2), (600, 4, 1.2)):
        assert t_fast.features_per_level(*args) == j_fast.features_per_level(*args)
    assert t_pyr.level_sizes(376, 1241, 8, 1.2) == j_pyr.level_sizes(376, 1241, 8, 1.2)


def test_gaussian_blur(rng):
    img = rng.uniform(0, 255, (93, 171)).astype(np.float32)
    ref = np.asarray(j_pyr.gaussian_blur(jnp.asarray(img)))
    out = t_pyr.gaussian_blur(_t(img)).numpy()
    # same taps and order, but XLA's CPU loop fusion rounds some of the 14
    # multiply-adds differently (fused multiply-adds): pixels differ by up
    # to 2 ulp (ulp(255) = 1.5e-5), so the bound is 4e-5, not 1e-5
    np.testing.assert_allclose(out, ref, atol=4e-5)


def test_resize_bilinear_matches_jax_image_resize(rng):
    img = rng.uniform(0, 255, (376, 1241)).astype(np.float32)
    for hw in ((313, 1034), (261, 862)):
        # f32 semantics, as the JAX package runs outside the test suite: with
        # x64 on, jax.image.resize builds its weights in f64 (up to 0.02 off)
        with jax.enable_x64(False):
            ref = np.asarray(j_pyr.resize_bilinear(jnp.asarray(img), hw))
        out = t_pyr.resize_bilinear(_t(img), hw).numpy()
        # bit-identical f32 weight matrices; the two products round their
        # two-term sums differently at up to 2 ulp (ulp(255) = 1.5e-5)
        np.testing.assert_allclose(out, ref, atol=4e-5)


@pytest.mark.parametrize("h, w", [(128, 256), (93, 171)])
def test_k1_plain_version_matches_jax(rng, h, w):
    """K1's plain path (a CPU tensor) against the JAX XLA pair and against
    the Pallas kernel in interpret mode."""
    img = _int_image(rng, h, w)
    score, blur = t_frontend.fast_and_blur(_t(img))
    score_x = np.asarray(j_fast.fast_score(jnp.asarray(img)))
    blur_x = np.asarray(j_pyr.gaussian_blur(jnp.asarray(img)))
    score_p, blur_p = (np.asarray(a) for a in j_frontend.fast_and_blur(jnp.asarray(img),
                                                                        interpret=True))
    np.testing.assert_array_equal(score.numpy(), score_x)
    np.testing.assert_array_equal(score.numpy(), score_p)
    np.testing.assert_allclose(blur.numpy(), blur_x, atol=4e-5)  # see test_gaussian_blur
    # the bar the JAX package holds its own kernel to
    np.testing.assert_allclose(blur.numpy(), blur_p, atol=1e-3)


def _level_lists(rng, which):
    if which == "pyramid3":
        img = _t(_int_image(rng, 128, 256))
        return [lv.contiguous() for lv in t_pyr.build_pyramid(img, 128, 256, 3, 1.2)]
    return [_t(_int_image(rng, *{"aligned": (128, 256), "unaligned": (93, 171)}[which]))]


@pytest.mark.parametrize("which", ["aligned", "unaligned", "pyramid3"])
def test_k1_levels_equal_per_level_calls_plus_composite(rng, which):
    """The multi-level entry against the one-level entry on every level
    plus ``brief_cuda.composite``, bit for bit, for every combination of
    outputs asked for."""
    levels = _level_lists(rng, which)
    pairs = [t_frontend.fast_and_blur(lv) for lv in levels]
    comp_ref, offs_ref = t_bp.composite([b for _, b in pairs])
    assert (*comp_ref.shape, offs_ref) == t_bp.composite_layout([lv.shape for lv in levels])
    for want_blur in (False, True):
        for want_comp in (False, True):
            scores, blurs, comp, offs = t_frontend.fast_and_blur_levels(
                levels, want_blur=want_blur, want_comp=want_comp)
            assert len(scores) == len(levels)
            for (s_ref, b_ref), s, lv in zip(pairs, scores, levels):
                assert s.shape == lv.shape and torch.equal(s, s_ref)
            if want_blur:
                assert all(torch.equal(b, b_ref) for b, (_, b_ref) in zip(blurs, pairs))
            else:
                assert blurs is None
            if want_comp:
                assert offs == offs_ref and torch.equal(comp, comp_ref)
            else:
                assert comp is None and offs is None
    # the default asks for the composite alone
    _, blurs, comp, _ = t_frontend.fast_and_blur_levels(levels)
    assert blurs is None and torch.equal(comp, comp_ref)


@pytest.mark.parametrize("which", ["aligned", "unaligned", "pyramid3"])
def test_k1_levels_match_jax_kernel_and_composite(rng, which):
    """Per level against the Pallas kernel in interpret mode (score exact,
    blur 4e-5 against XLA's and 1e-3 against the kernel's, the bars of
    ``test_k1_plain_version_matches_jax``), and the composite against the
    one ``brief_pallas.descriptors_multilevel`` assembles from the JAX
    blurs: equal after rounding wherever the two blurs differ by less than
    the JAX blur's distance to a .5 tie."""
    levels = _level_lists(rng, which)
    scores, blurs, comp, offs = t_frontend.fast_and_blur_levels(levels, want_blur=True)
    j_blurs = []
    for lv, score, blur in zip(levels, scores, blurs):
        score_p, blur_p = (np.asarray(a) for a in j_frontend.fast_and_blur(
            jnp.asarray(lv.numpy()), interpret=True))
        blur_x = np.asarray(j_pyr.gaussian_blur(jnp.asarray(lv.numpy())))
        np.testing.assert_array_equal(score.numpy(), score_p)
        np.testing.assert_allclose(blur.numpy(), blur_x, atol=4e-5)
        np.testing.assert_allclose(blur.numpy(), blur_p, atol=1e-3)
        j_blurs.append(blur_x)
    # the composite as brief_pallas.descriptors_multilevel builds it
    W0 = ((max(b.shape[1] for b in j_blurs) + 127) // 128) * 128 + 128
    Hc = ((sum(b.shape[0] for b in j_blurs) + 7) // 8) * 8 + 16
    j_comp = jnp.zeros((Hc, W0), jnp.float32)
    row = 0
    for b, off in zip(j_blurs, offs):
        assert off == row
        j_comp = jax.lax.dynamic_update_slice(j_comp, jnp.round(jnp.asarray(b)), (off, 0))
        row += b.shape[0]
    j_comp = np.asarray(j_comp)
    assert comp.shape == j_comp.shape
    decided = np.ones(j_comp.shape, bool)      # padding: zero on both sides
    for b_j, b_t, off in zip(j_blurs, blurs, offs):
        h, w = b_j.shape
        tie_dist = np.abs(np.abs(b_j - np.floor(b_j)) - 0.5)
        decided[off:off + h, :w] = np.abs(b_t.numpy() - b_j) < tie_dist
    np.testing.assert_array_equal(comp.numpy()[decided], j_comp[decided])
    # the tie rule set aside 1, 0 and 1 pixels of these 32,768, 15,903 and
    # 71,401 when this was written; more than 1 in 1000 would mean that the
    # blurs no longer agree to ~1e-5
    assert (~decided).sum() <= decided.size // 1000, (~decided).sum()
    assert j_bp.HALF == t_bp.HALF and j_bp.PATCH == t_bp.PATCH


def test_k1_wrapper_rejects_unsupported_devices():
    img = torch.zeros((16, 16), device="meta")
    with pytest.raises(ValueError):
        t_frontend.fast_and_blur(img)
    with pytest.raises(ValueError):
        t_frontend.fast_and_blur_levels([img])
    # an empty list, and more levels than one launch takes
    with pytest.raises(ValueError, match="1 to 16 levels"):
        t_frontend.fast_and_blur_levels([])
    with pytest.raises(ValueError, match="1 to 16 levels"):
        t_frontend.fast_and_blur_levels([img] * (t_frontend.MAX_LEVELS + 1))


def test_k1_tile_count():
    # 1241x376 at 8 levels of scale 1.2: the blocks of one launch
    shapes = t_pyr.level_sizes(376, 1241, 8, 1.2)
    assert t_frontend.n_tiles(shapes) == 468 + 330 + 243 + 161 + 114 + 80 + 52 + 44
    # and those that zero the (1752, 1408) composite's padding, 32 rows x
    # 256 columns each: right of each level, then the 21 rows below the last
    assert t_frontend.n_fill_blocks(shapes) == 12 + 20 + 27 + 21 + 24 + 20 + 16 + 20 + 6
