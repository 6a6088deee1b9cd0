"""Port vs JAX: IC orientation and steered BRIEF (K2's plain version, the
composite layout, and the Pallas kernel in interpret mode).

BRIEF is compared given the SAME angles: angles themselves come from
prefix sums that torch and XLA add in different orders (see
``test_ic_angle``), and one flipped angle flips descriptor bits."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_rgbl_tpu.ops import brief_pallas as j_bp
from orb_slam3_rgbl_tpu.ops import orb as j_orb
from orb_slam3_rgbl_tpu_torch.ops import brief_cuda as t_bp
from orb_slam3_rgbl_tpu_torch.ops import orb as t_orb


def _t(a):
    return torch.from_numpy(np.array(a))


def _setup(rng, H=256, W=512, N=70):
    img = np.round(rng.uniform(0, 255, (H, W))).astype(np.float32)
    uv = np.stack([rng.integers(20, W - 160, N), rng.integers(20, H - 28, N)], 1).astype(np.int32)
    ang = rng.uniform(-np.pi, np.pi, N).astype(np.float32)
    return img, uv, ang


def _smooth_image(rng, H, W):
    # structured (blurred) intensities, as real pyramid levels are
    img = rng.uniform(0, 255, (H // 4 + 1, W // 4 + 1)).astype(np.float32)
    return np.kron(img, np.ones((4, 4), np.float32))[:H, :W]


def test_pattern_tables_match():
    np.testing.assert_array_equal(t_orb.PATTERN_A, j_orb.PATTERN_A)
    np.testing.assert_array_equal(t_orb.PATTERN_B, j_orb.PATTERN_B)
    np.testing.assert_array_equal(t_orb.UMAX, j_orb.UMAX)
    np.testing.assert_array_equal(t_orb.CIRC_MASK, j_orb.CIRC_MASK)


def test_ic_angle(rng):
    H, W = 120, 400
    img = _smooth_image(rng, H, W)
    uv = np.stack([rng.integers(19, W - 19, 300), rng.integers(19, H - 19, 300)], 1).astype(np.int32)
    a_j = np.asarray(j_orb.ic_angle(jnp.asarray(img), jnp.asarray(uv)))
    a_t = t_orb.ic_angle(_t(img), _t(uv)).numpy()
    # the moments subtract prefix sums of ~1e6 that torch and XLA add in
    # different orders: the angles agree to 2e-3 rad (BRIEF tolerates
    # this; the descriptor tests below feed both sides the same angles)
    diff = np.abs(np.angle(np.exp(1j * (a_t.astype(np.float64) - a_j))))
    assert diff.max() < 2e-3, diff.max()
    # the keypoint-only evaluation equals the dense maps up to sum order
    m10, m01 = t_orb.ic_moment_maps(_t(img))
    dense = torch.atan2(m01[uv[:, 1], uv[:, 0]], m10[uv[:, 1], uv[:, 0]]).numpy()
    diff = np.abs(np.angle(np.exp(1j * (a_t.astype(np.float64) - dense))))
    assert diff.max() < 2e-3, diff.max()
    mj10, mj01 = (np.asarray(m) for m in j_orb.ic_moment_maps(jnp.asarray(img)))
    # moments of magnitude ~1e5: relative agreement 1e-4
    np.testing.assert_allclose(m10.numpy(), mj10, rtol=0, atol=1e-4 * np.abs(mj10).max())
    np.testing.assert_allclose(m01.numpy(), mj01, rtol=0, atol=1e-4 * np.abs(mj01).max())


def test_brief_descriptors_bit_exact_given_same_angles(rng):
    img, uv, ang = _setup(rng)
    d_j = np.asarray(j_orb.brief_descriptors(jnp.asarray(img), jnp.asarray(uv), jnp.asarray(ang)))
    d_t = t_orb.brief_descriptors(_t(img), _t(uv), _t(ang)).numpy().view(np.uint32)
    np.testing.assert_array_equal(d_t, d_j)


def test_index_tables_and_k2_plain_version(rng):
    img, uv, ang = _setup(rng)
    idx_t = t_bp.continuous_index_tables(_t(ang))
    np.testing.assert_array_equal(idx_t.numpy(),
                                  np.asarray(j_bp.continuous_index_tables(jnp.asarray(ang))))
    corners = _t(uv - t_bp.HALF)
    d_plain = t_bp.brief_continuous_plain(_t(img), corners, idx_t)
    d_wrap = t_bp.brief_continuous(_t(img), corners, _t(ang))      # CPU → tables, then plain
    d_gather = t_orb.brief_descriptors(_t(img), _t(uv), _t(ang))
    assert torch.equal(d_plain, d_wrap)
    assert torch.equal(d_plain, d_gather)
    # and against the Pallas kernel in interpret mode, same tables
    N = uv.shape[0]
    S = ((N + j_bp.BLK - 1) // j_bp.BLK) * j_bp.BLK
    uvb = jnp.ones((S, 2), jnp.int32).at[:N].set(jnp.asarray(uv - j_bp.HALF))
    idx = jnp.zeros((S, 512), jnp.int32).at[:N].set(jnp.asarray(idx_t.numpy()))
    d_pal = np.asarray(j_bp.brief_continuous_pallas(jnp.asarray(img), uvb, idx, interpret=True))[:N]
    np.testing.assert_array_equal(d_plain.numpy().view(np.uint32), d_pal)
    np.testing.assert_array_equal(d_wrap.numpy().view(np.uint32), d_pal)


def test_descriptors_multilevel_matches_jax(rng):
    img, uv, ang = _setup(rng)
    lvl1 = np.round(rng.uniform(0, 255, (128, 256))).astype(np.float32)
    uv2 = np.stack([rng.integers(20, 236, 30), rng.integers(20, 100, 30)], 1).astype(np.int32)
    ang2 = rng.uniform(-np.pi, np.pi, 30).astype(np.float32)
    comp, offs = t_bp.composite([_t(img), _t(lvl1)])
    assert (comp.shape, offs) == ((256 + 128 + 16, 512 + 128), [0, 256])
    assert t_bp.composite_layout([img.shape, lvl1.shape]) == (400, 640, [0, 256])
    d_t = t_bp.descriptors_multilevel(comp, offs, [_t(uv), _t(uv2)], [_t(ang), _t(ang2)])
    j_args = ([jnp.asarray(img), jnp.asarray(lvl1)], [jnp.asarray(uv), jnp.asarray(uv2)],
              [jnp.asarray(ang), jnp.asarray(ang2)])
    d_cpu = j_bp.descriptors_multilevel(*j_args, use_pallas=False, mode="continuous")
    d_pal = j_bp.descriptors_multilevel(*j_args, use_pallas=True, interpret=True,
                                        mode="continuous")
    for a, b, c in zip(d_t, d_cpu, d_pal):
        np.testing.assert_array_equal(a.numpy().view(np.uint32), np.asarray(b))
        np.testing.assert_array_equal(a.numpy().view(np.uint32), np.asarray(c))


def test_unpack_and_pack_roundtrip(rng):
    words = rng.integers(0, 2 ** 32, (50, 8), dtype=np.uint32)
    pm_t = t_orb.unpack_descriptors_pm1(_t(words.view(np.int32))).numpy()
    pm_j = np.asarray(j_orb.unpack_descriptors_pm1(jnp.asarray(words), jnp.float32))
    np.testing.assert_array_equal(pm_t, pm_j)
    repacked = t_orb.pack_bits(torch.from_numpy(pm_t > 0)).numpy().view(np.uint32)
    np.testing.assert_array_equal(repacked, words)


def test_k2_wrapper_checks_inputs():
    comp = torch.zeros((64, 64), device="meta")
    with pytest.raises(ValueError):
        t_bp.brief_continuous(comp, torch.zeros((1, 2), dtype=torch.int32),
                              torch.zeros((1,), dtype=torch.float32))
    with pytest.raises(ValueError, match="only on a CUDA tensor"):
        t_bp.rotation_tables(torch.zeros((3,), dtype=torch.float32))


@pytest.mark.parametrize("n", [1, 5, 70])
def test_k2_angles_in_words_out_matches_pallas(rng, n):
    """``brief_continuous(comp, corners, angle)`` against the Pallas kernel
    in interpret mode, which is fed JAX's own index tables of the same
    angles: bit for bit, on keypoint counts that leave the kernels' last
    block partly filled."""
    img, uv, ang = _setup(rng, N=n)
    d_t = t_bp.brief_continuous(_t(img), _t(uv - t_bp.HALF), _t(ang))
    S = ((n + j_bp.BLK - 1) // j_bp.BLK) * j_bp.BLK
    uvb = jnp.ones((S, 2), jnp.int32).at[:n].set(jnp.asarray(uv - j_bp.HALF))
    idx = jnp.zeros((S, 512), jnp.int32).at[:n].set(
        j_bp.continuous_index_tables(jnp.asarray(ang)))
    d_pal = np.asarray(j_bp.brief_continuous_pallas(jnp.asarray(img), uvb, idx, interpret=True))[:n]
    np.testing.assert_array_equal(d_t.numpy().view(np.uint32), d_pal)
    assert t_bp.brief_continuous(_t(img), _t(uv[:0] - t_bp.HALF), _t(ang[:0])).shape == (0, 8)
