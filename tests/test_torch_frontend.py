"""Port vs JAX: pyramid, FAST, keypoint selection and the fused frontend
(K1's plain version, and the Pallas kernel in interpret mode).

Inputs are made with ``numpy.random.default_rng`` and handed to both
packages as f32 numpy arrays; JAX runs on the CPU."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_rgbl_tpu.ops import fast as j_fast
from orb_slam3_rgbl_tpu.ops import frontend_pallas as j_frontend
from orb_slam3_rgbl_tpu.ops import pyramid as j_pyr
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


def test_k1_wrapper_rejects_unsupported_devices():
    img = torch.zeros((16, 16), device="meta")
    with pytest.raises(ValueError):
        t_frontend.fast_and_blur(img)
