"""The roofline's count of bytes and operations against a count by hand."""

import pytest

from slambench import roofline


def test_bytes_and_flops_by_hand():
    # 1 pose, 1 landmark, 2 observations, 1 LM iteration of 1 CG step
    shapes = dict(n_obs=2, n_kf=1, n_lm=1)
    s = dict(lm_iterations=1, cg_steps=1)
    obs_in = 2 * 20                   # keyframe index + u, v, u_R, 1/σ² a observation
    state = (7 + 3) * 4
    vec = (6 + 3) * 4
    pre = (36 + 9) * 4
    lin = obs_in + state + 2 * 31 * 4
    grad = 2 * 31 * 4 + vec + pre
    cg = 2 * (28 * 4 + 4) + 4 * vec + pre + 3 * vec
    acc = obs_in + state + vec + state
    final = obs_in + state
    c = roofline.counts(shapes, s)
    assert c["bytes"] == lin + grad + cg + acc + final == 1692
    flops = (2 * (30 + 180) + 2 * 2 * 162 + 432 + 54 + 2 * 111 + 144 + 54 + 2 * 48) + 2 * 48
    assert c["flops"] == flops


def test_the_count_grows_with_the_schedule_and_is_bound_by_bytes():
    shapes = dict(n_obs=333_253, n_kf=199, n_lm=95_520)
    one = roofline.counts(shapes, dict(lm_iterations=1, cg_steps=64))
    two = roofline.counts(shapes, dict(lm_iterations=2, cg_steps=64))
    assert two["bytes"] > 1.9 * one["bytes"]
    t, bound = roofline.least_seconds(roofline.counts(shapes, dict(lm_iterations=16, cg_steps=64)))
    assert bound == "bytes"
    assert t == pytest.approx(53_077_244_264 / 3.35e12)
