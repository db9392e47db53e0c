"""Pose interpolation and the damped spring of the port
(deepfactors_tpu_torch/utils/interp.py) against the JAX package's, on the
same numpy poses from a seed: lerp, slerp (both arcs, and the nlerp branch
near parallel), interpolate_pose and DampedSpring, within 1e-6."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from deepfactors_tpu.geometry.se3 import SE3 as JSE3
from deepfactors_tpu.utils import interp as jit_
from deepfactors_tpu_torch.geometry.se3 import SE3
from deepfactors_tpu_torch.utils import interp as it

torch.set_num_threads(2)


def _quat(rng):
    q = rng.randn(4).astype(np.float32)
    return q / np.linalg.norm(q)


@pytest.mark.parametrize("case", ["random", "opposite", "parallel"])
@pytest.mark.parametrize("t", [0.0, 0.3, 1.0])
def test_slerp_matches_jax(case, t):
    rng = np.random.RandomState(0)
    q0 = _quat(rng)
    q1 = {"random": _quat(rng), "opposite": -q0 + 0.01 * _quat(rng),
          "parallel": q0}[case].astype(np.float32)
    a = it.slerp(torch.from_numpy(q0), torch.from_numpy(q1), t)
    b = jit_.slerp(jnp.asarray(q0), jnp.asarray(q1), t)
    np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    assert abs(float(torch.linalg.norm(a)) - 1.0) < 1e-6


def test_pose_and_spring_match_jax():
    rng = np.random.RandomState(1)
    p0 = (_quat(rng), rng.randn(3).astype(np.float32))
    p1 = (_quat(rng), rng.randn(3).astype(np.float32))
    t0 = SE3(*(torch.from_numpy(x) for x in p0))
    t1 = SE3(*(torch.from_numpy(x) for x in p1))
    j0 = JSE3(*(jnp.asarray(x) for x in p0))
    j1 = JSE3(*(jnp.asarray(x) for x in p1))
    np.testing.assert_allclose(it.lerp(t0.t, t1.t, 0.25).numpy(),
                               np.asarray(jit_.lerp(j0.t, j1.t, 0.25)),
                               atol=1e-6)
    for u, v in zip(it.interpolate_pose(t0, t1, 0.4),
                    jit_.interpolate_pose(j0, j1, 0.4)):
        np.testing.assert_allclose(u.numpy(), np.asarray(v), atol=1e-6)
    # numpy poses (the facade's host poses) interpolate too
    mid = it.interpolate_pose(SE3(*p0), SE3(*p1), 0.5)
    np.testing.assert_allclose(mid.t.numpy(), (p0[1] + p1[1]) / 2, atol=1e-6)
    a, b = it.DampedSpring(t0, 0.1), jit_.DampedSpring(j0, 0.1)
    for _ in range(20):
        a.step(t1, 0.05)
        b.step(j1, 0.05)
    for u, v in zip(a.pose, b.pose):
        np.testing.assert_allclose(u.numpy(), np.asarray(v), atol=1e-5)
    for _ in range(50):
        a.step(t1, 0.1)
    assert float(torch.linalg.norm(a.pose.t - t1.t)) < 1e-3
