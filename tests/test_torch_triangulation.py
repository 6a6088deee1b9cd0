"""Port vs JAX: the two-view triangulation primitives on the same f32
inputs (seeded numpy): 1e-5 of each result's scale, but 1e-4 and 2e-4 for
the two DLT forms, whose rounding grows with 1/sin² of the parallax (see
test_two_view_functions_match_jax); and, in both packages, the closed-form ``triangulate_fast`` against the eigenvector
form ``triangulate_dlt`` over parallax angles from 0.05° to 30°.

JAX runs with x64 off, as outside the test suite."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_rgbl_tpu.geometry import triangulation as j_tri
from orb_slam3_rgbl_tpu_torch.geometry import lie as t_lie
from orb_slam3_rgbl_tpu_torch.geometry import triangulation as t_tri

RTOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pose(rng, trans_scale):
    q = np.array([1.0, 0, 0, 0]) + rng.normal(0, 0.05, 4)
    return np.concatenate([q / np.linalg.norm(q), rng.normal(0, trans_scale, 3)]).astype(np.float32)


def _two_views(rng, n=300, baseline=0.8, depth=(4.0, 40.0), noise=0.0):
    """n world points seen from two poses ``baseline`` apart: bearings
    (z = 1) in both cameras, the poses broadcast to (n, 7), pixels under
    K and the points."""
    T1 = _pose(rng, 0.3)
    T2 = _pose(rng, 0.3)
    T2[4:] = T1[4:] + np.array([baseline, 0.05 * baseline, 0.1 * baseline], np.float32)
    Xc = np.stack([rng.uniform(-6, 6, n), rng.uniform(-2, 2, n), rng.uniform(*depth, n)], 1)
    X = t_lie.np_se3_apply(t_lie.np_se3_inv(T1), Xc.astype(np.float32))
    K = np.array([[420.0, 0, 160.0], [0, 415.0, 96.0], [0, 0, 1]], np.float32)
    out = {"X": X, "K": K}
    for name, T in (("1", T1), ("2", T2)):
        pc = t_lie.np_se3_apply(T, X)
        xn = (pc / pc[:, 2:3] + np.concatenate([rng.normal(0, noise, (n, 2)), np.zeros((n, 1))], 1))
        out["xn" + name] = xn.astype(np.float32)
        out["T" + name] = np.broadcast_to(T, (n, 7)).copy()
        out["uv" + name] = (xn @ K.T)[:, :2].astype(np.float32)
    return out


def _both(name, *arrays):
    """The function ``name`` of both packages on the same arrays."""
    with jax.enable_x64(False):
        want = np.asarray(getattr(j_tri, name)(*(jnp.asarray(a) for a in arrays)))
    got = getattr(t_tri, name)(*(torch.from_numpy(np.array(a)) for a in arrays)).numpy()
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    return got, want


def _close(got, want, rtol=RTOL):
    """Relative to the array's own scale: rtol · max|want|."""
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * np.abs(want).max())


@pytest.mark.parametrize("name", ["triangulate_dlt", "triangulate_fast", "triangulate_midpoint",
                                  "parallax_cos"])
def test_two_view_functions_match_jax(rng, name):
    v = _two_views(rng, noise=1e-3)
    got, want = _both(name, v["xn1"], v["xn2"], v["T1"], v["T2"])
    if name.startswith("triangulate"):
        # eigh and the 3×3 adjugate amplify f32 rounding by the pair's
        # conditioning (~1/sin² of the parallax), and the two packages sum
        # in different orders: per point the packages differ by up to
        # 2.7e-5 (dlt), 7.7e-5 (fast) and 2.1e-5 (midpoint) of the point's
        # distance at 1°-5° of parallax, under 3e-5 above 5°. Held at ≥ 1°
        # (the mapper's gate is 1.15°) to 1e-4 (2e-4 for fast) of the
        # scene's extent; 1e-5 holds for midpoint and for parallax_cos
        cosp = _both("parallax_cos", v["xn1"], v["xn2"], v["T1"], v["T2"])[1]
        sel = cosp < np.cos(np.deg2rad(1.0))
        assert sel.sum() > 100
        _close(got[sel], want[sel], rtol={"triangulate_dlt": 1e-4, "triangulate_fast": 2e-4,
                                          "triangulate_midpoint": 1e-5}[name])
    else:
        _close(got, want)


def test_fundamental_and_epipolar_distance_match_jax(rng):
    v = _two_views(rng)
    F_t, F_j = _both("fundamental_from_poses", v["K"], v["K"], v["T1"][0], v["T2"][0])
    _close(F_t, F_j)
    # the pairwise form the mapper uses: (N, 1, 2) against (1, N, 2)
    uv2 = v["uv2"] + rng.normal(0, 2.0, v["uv2"].shape).astype(np.float32)
    d_t, d_j = _both("epipolar_distance_sq", F_j, v["uv1"][:, None, :], uv2[None, :, :])
    assert d_t.shape == (300, 300)
    # a squared distance is a ratio of two f32 sums: 1e-5 of its own size
    # plus what cancellation in the numerator leaves near the line
    np.testing.assert_allclose(d_t, d_j, rtol=1e-3, atol=1e-5 * d_j.max())
    np.testing.assert_allclose(np.median(np.abs(d_t - d_j) / np.maximum(d_j, 1.0)), 0, atol=1e-5)
    # true correspondences lie on their lines
    on_line = _both("epipolar_distance_sq", F_j, v["uv1"], v["uv2"])[0]
    assert on_line.max() < 1e-2


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_triangulate_fast_agrees_with_dlt_over_parallax(rng, package):
    """The closed form fixes w = 1; it must agree with the eigenvector
    form for finite points at every parallax the mapper accepts (its gate
    is cos < 0.9998, 1.15°) and degrade no worse below it. Exact bearings,
    points 10-30 m away; the baseline sets the parallax."""
    worst = {}
    for deg in (0.05, 0.2, 1.0, 2.0, 5.0, 15.0, 30.0):
        baseline = 2.0 * 20.0 * np.tan(np.deg2rad(deg) / 2.0)
        v = _two_views(rng, n=200, baseline=baseline, depth=(10.0, 30.0))
        args = (v["xn1"], v["xn2"], v["T1"], v["T2"])
        if package == "jax":
            with jax.enable_x64(False):
                fast = np.asarray(j_tri.triangulate_fast(*(jnp.asarray(a) for a in args)))
                dlt = np.asarray(j_tri.triangulate_dlt(*(jnp.asarray(a) for a in args)))
        else:
            fast = t_tri.triangulate_fast(*(torch.from_numpy(a) for a in args)).numpy()
            dlt = t_tri.triangulate_dlt(*(torch.from_numpy(a) for a in args)).numpy()
        depth = np.linalg.norm(v["X"], axis=1)
        worst[deg] = (float((np.linalg.norm(fast - dlt, axis=1) / depth).max()),
                      float((np.linalg.norm(fast - v["X"], axis=1) / depth).max()))
    for deg, (vs_dlt, vs_truth) in worst.items():
        if deg >= 2.0:
            assert vs_dlt < 1e-3 and vs_truth < 1e-3, (package, worst)
        elif deg >= 1.0:
            assert vs_dlt < 1e-2 and vs_truth < 1e-2, (package, worst)
        else:
            assert np.isfinite(vs_dlt), (package, worst)
