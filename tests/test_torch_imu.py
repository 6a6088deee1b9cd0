"""Port vs JAX: IMU preintegration (``imu/preintegration.py``) and the IMU
frontend (``slam/imu_frontend.py``) on the same float32 samples made from a
seed with numpy.

The JAX package scans a window padded to a tier with a validity mask; the
port loops over the real samples. Tolerances: every preintegrated quantity
within 2e-5 of the largest magnitude of its field (relative; the covariance
is ~1e-9 in absolute terms), deltas after a bias change and residuals within
1e-5 absolute. JAX runs with x64 off, as outside the test suite."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from orb_slam3_rgbl_tpu.config import ImuConfig as JImuConfig, kitti_rgbl_config as j_cfg
from orb_slam3_rgbl_tpu.imu import preintegration as jpre
from orb_slam3_rgbl_tpu.slam import imu_frontend as jfront
from orb_slam3_rgbl_tpu_torch import convert
from orb_slam3_rgbl_tpu_torch.imu import preintegration as tpre
from orb_slam3_rgbl_tpu_torch.slam import imu_frontend as tfront

import dataclasses

CPU = torch.device("cpu")
FIELDS = ("dt", "dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa", "cov", "bg", "ba")


def _samples(seed: int, S: int, t0: float = 0.0):
    """(S, 7) [t, acc, gyro]: a body turning and accelerating, 200 Hz with jitter."""
    rng = np.random.default_rng(seed)
    t = t0 + np.cumsum(rng.uniform(0.0045, 0.0055, S))
    acc = np.array([0.3, -0.2, 9.81]) + rng.normal(0, 0.5, (S, 3))
    gyr = np.array([0.1, -0.3, 0.2]) + rng.normal(0, 0.2, (S, 3))
    return np.concatenate([t[:, None], acc, gyr], axis=1).astype(np.float32)


def _jbias(bg, ba):
    return jpre.ImuBias(jnp.asarray(bg, jnp.float32), jnp.asarray(ba, jnp.float32))


def _tbias(bg, ba):
    return tpre.ImuBias(torch.as_tensor(np.asarray(bg, np.float32)),
                        torch.as_tensor(np.asarray(ba, np.float32)))


def _close(a_tuple, b_tuple, rel=2e-5):
    for name, a, b in zip(FIELDS, a_tuple, b_tuple):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        scale = max(np.abs(a).max(), 1e-30)
        assert np.abs(a - b).max() <= rel * scale, (name, np.abs(a - b).max(), scale)


def _jax_preint(samples, bg, ba):
    cfg = dataclasses.replace(j_cfg(), imu=JImuConfig())
    with jax.enable_x64(False):
        return jfront.preintegrate_samples(samples, _jbias(bg, ba), cfg.imu.noise_acc,
                                           cfg.imu.noise_gyro)


def _port_preint(samples, bg, ba):
    return tfront.preintegrate_samples(samples, _tbias(bg, ba), 2.0e-3, 1.7e-4, CPU)


@pytest.mark.parametrize("S,bias", [(2, 0.0), (37, 0.0), (120, 0.01)])
def test_preintegrate_matches_padded_jax(S, bias):
    """The padded JAX scan (tier 64 / 256) and the port's loop over the real
    samples agree on every field."""
    s = _samples(S, S)
    bg, ba = np.full(3, bias), np.full(3, -2 * bias)
    pj = _jax_preint(s, bg, ba)
    assert pj.cov.shape == (9, 9)
    pt = _port_preint(s, bg, ba)
    _close(jfront.preint_to_numpy(pj), tfront.preint_to_numpy(pt))


def _pair():
    s = _samples(5, 90)
    return s[:40], s[40:]


def test_merge_matches_jax():
    s1, s2 = _pair()
    bg, ba = np.array([0.01, -0.02, 0.005]), np.array([0.05, 0.0, -0.03])
    with jax.enable_x64(False):
        mj = jpre.merge(_jax_preint(s1, bg, ba), _jax_preint(s2, bg * 0.5, ba))
        mj = jfront.preint_to_numpy(mj)
    mt = tpre.merge(_port_preint(s1, bg, ba), _port_preint(s2, bg * 0.5, ba))
    _close(mj, tfront.preint_to_numpy(mt))


def test_bias_corrected_deltas_predict_and_residual():
    s = _samples(9, 60)
    pj = _jax_preint(s, np.zeros(3), np.zeros(3))
    pt = _port_preint(s, np.zeros(3), np.zeros(3))
    nb = (np.array([0.004, -0.002, 0.003]), np.array([0.02, -0.01, 0.03]))
    rng = np.random.default_rng(3)
    q1 = rng.normal(size=4).astype(np.float32)
    q1 /= np.linalg.norm(q1)
    q2 = rng.normal(size=4).astype(np.float32)
    q2 /= np.linalg.norm(q2)
    v1, p1, v2, p2 = (rng.normal(size=3).astype(np.float32) for _ in range(4))
    with jax.enable_x64(False):
        jb = _jbias(*nb)
        jd = [np.asarray(f(pj, jb)) for f in (jpre.delta_rotation, jpre.delta_velocity,
                                               jpre.delta_position)]
        jpred = [np.asarray(x) for x in jpre.predict_state(
            jnp.asarray(q1), jnp.asarray(v1), jnp.asarray(p1), pj, jb)]
        jres = np.asarray(jpre.inertial_residual(
            pj, jnp.asarray(q1), jnp.asarray(v1), jnp.asarray(p1), jnp.asarray(q2),
            jnp.asarray(v2), jnp.asarray(p2), jb))
    tb = _tbias(*nb)
    td = [f(pt, tb).numpy() for f in (tpre.delta_rotation, tpre.delta_velocity,
                                       tpre.delta_position)]
    T = torch.as_tensor
    tpred = [x.numpy() for x in tpre.predict_state(T(q1), T(v1), T(p1), pt, tb)]
    tres = tpre.inertial_residual(pt, T(q1), T(v1), T(p1), T(q2), T(v2), T(p2), tb).numpy()
    for a, b in zip(jd + jpred, td + tpred):
        np.testing.assert_allclose(b, a, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tres, jres, atol=1e-5, rtol=1e-5)


def test_accumulator_windows_and_storage():
    """``ImuAccumulator``: blocks added frame by frame, preintegrated at a
    bias, equal to the JAX accumulator; the host tuple round-trips; a batch
    from one upload equals the tuples; EuRoC-sized timestamps (1.4e9 s)
    give the same window as small ones (float64 sample times)."""
    jcfg = dataclasses.replace(j_cfg(), imu=JImuConfig())
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    s = _samples(11, 75)
    ja, ta = jfront.ImuAccumulator(jcfg), tfront.ImuAccumulator(tcfg, CPU)
    for blk in (s[:10], s[10:11], s[11:40], s[40:]):
        ja.add(blk)
        ta.add(blk)
    assert ja.n == ta.n == 75
    bias = (np.array([0.01, 0.0, -0.01]), np.array([0.0, 0.02, 0.0]))
    with jax.enable_x64(False):
        pj = jfront.preint_to_numpy(ja.preintegrate(_jbias(*bias)))
    pt = ta.preintegrate(tpre.ImuBias(*bias))
    assert ta.preintegrate(tpre.ImuBias(*bias)) is pt          # kept within the frame
    _close(pj, tfront.preint_to_numpy(pt))
    back = tfront.preint_to_numpy(tfront.preint_from_numpy(tfront.preint_to_numpy(pt), CPU))
    _close(tfront.preint_to_numpy(pt), back, rel=0.0)
    batch = tfront.stack_preints([pj, tfront.preint_to_numpy(pt)], CPU)
    assert batch.cov.shape == (2, 9, 9) and batch.bias0.bg.shape == (2, 3)
    np.testing.assert_array_equal(batch.dV[0].numpy(), pj[2])

    late = s.astype(np.float64)
    late[:, 0] += 1.4e9
    ta2 = tfront.ImuAccumulator(tcfg, CPU)
    ta2.add(late)
    _close(tfront.preint_to_numpy(ta2.preintegrate(tpre.ImuBias(*bias))),
           tfront.preint_to_numpy(pt), rel=1e-3)
    ta.reset()
    assert ta.n == 0 and ta.preintegrate(tpre.ImuBias(*bias)) is None


def test_body_cam_extrinsics_match_jax():
    M = np.array([[0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975],
                  [0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768],
                  [-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949],
                  [0.0, 0.0, 0.0, 1.0]])
    jcfg = dataclasses.replace(j_cfg(), imu=JImuConfig(T_body_cam=tuple(M.reshape(-1))))
    tcfg = convert.config_from_dict(dataclasses.asdict(jcfg))
    with jax.enable_x64(False):
        jb, jc = jfront.body_cam_extrinsics(jcfg)
    tb, tc = tfront.body_cam_extrinsics(tcfg)
    np.testing.assert_allclose(tb, jb, atol=1e-6)
    np.testing.assert_allclose(tc, jc, atol=1e-6)


def test_incremental_accumulation_is_the_one_shot_integration():
    """Blocks added frame by frame and preintegrated after each add: the
    last result is the one-shot integration of all samples, to the bit
    (the kept integration of all samples but the last is continued)."""
    s = _samples(13, 64)
    acc = tfront.ImuAccumulator(convert.config_from_dict(
        dataclasses.asdict(dataclasses.replace(j_cfg(), imu=JImuConfig()))), CPU)
    bias = tpre.ImuBias(np.float32([0.01, 0.0, -0.01]), np.float32([0.0, 0.02, 0.0]))
    for lo, hi in ((0, 1), (1, 10), (10, 11), (11, 40), (40, 64)):
        acc.add(s[lo:hi])
        acc.preintegrate(bias)
    whole = tfront.preintegrate_samples(s, bias, 2.0e-3, 1.7e-4, CPU)
    _close(tfront.preint_to_numpy(acc.preintegrate(bias)), tfront.preint_to_numpy(whole), rel=0.0)

