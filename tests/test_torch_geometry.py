"""deepfactors_tpu_torch geometry (se3, camera, warping, m-estimators)
against the JAX package on identical seeded inputs (tolerance 1e-5 absolute
on O(1) quantities, fp32 both sides), plus the finite-difference Jacobian
checks of tests/test_warping.py run on the port in float64."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfactors_tpu.geometry import camera as jcm
from deepfactors_tpu.geometry import m_estimators as jme
from deepfactors_tpu.geometry import se3 as jse3
from deepfactors_tpu.geometry import warping as jwp
from deepfactors_tpu_torch.geometry import camera as tcm
from deepfactors_tpu_torch.geometry import m_estimators as tme
from deepfactors_tpu_torch.geometry import se3 as tse3
from deepfactors_tpu_torch.geometry import warping as twp

torch.set_num_threads(2)
TOL = 1e-5
CAM = dict(fx=277.12, fy=289.7, u0=160.0, v0=120.0, width=320, height=240)


def rand_poses(rng, n, tscale=0.3, rscale=0.5):
    w = rng.uniform(-rscale, rscale, (n, 3)).astype(np.float32)
    t = rng.uniform(-tscale, tscale, (n, 3)).astype(np.float32)
    q = np.asarray(jse3.so3_exp_quat(jnp.asarray(w)))
    return q, t


def J(q, t):
    return jse3.SE3(jnp.asarray(q), jnp.asarray(t))


def Tp(q, t):
    return tse3.SE3(torch.from_numpy(np.array(q)), torch.from_numpy(np.array(t)))


def close(a, b, tol=TOL):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), atol=tol, rtol=tol)


@pytest.mark.parametrize("name", ["mul", "relative_pose", "inverse", "local"])
def test_se3_group_ops(name):
    rng = np.random.RandomState(1)
    qa, ta = rand_poses(rng, 16)
    qb, tb = rand_poses(rng, 16)
    if name == "inverse":
        rj, rt = jse3.inverse(J(qa, ta)), tse3.inverse(Tp(qa, ta))
    else:
        rj = getattr(jse3, name)(J(qa, ta), J(qb, tb))
        rt = getattr(tse3, name)(Tp(qa, ta), Tp(qb, tb))
    for a, b in zip(rt if isinstance(rt, tuple) else (rt,),
                    rj if isinstance(rj, tuple) else (rj,)):
        close(a, b)


def test_se3_exp_log_retract_matrix():
    rng = np.random.RandomState(2)
    w = rng.uniform(-1, 1, (20, 3)).astype(np.float32)
    w[0] = 0.0
    w[1] = 1e-5
    close(tse3.so3_exp_quat(torch.from_numpy(w)), jse3.so3_exp_quat(jnp.asarray(w)))
    q, t = rand_poses(rng, 20)
    close(tse3.so3_log(torch.from_numpy(q)), jse3.so3_log(jnp.asarray(q)))
    R = np.asarray(jse3.quat_to_matrix(jnp.asarray(q)))
    close(tse3.quat_to_matrix(torch.from_numpy(q)), R)
    close(tse3.matrix_to_quat(torch.from_numpy(R)), jse3.matrix_to_quat(jnp.asarray(R)))
    d = rng.uniform(-0.2, 0.2, (20, 6)).astype(np.float32)
    for a, b in zip(tse3.retract(Tp(q, t), torch.from_numpy(d)),
                    jse3.retract(J(q, t), jnp.asarray(d))):
        close(a, b)
    pts = rng.standard_normal((20, 3)).astype(np.float32)
    close(tse3.act(Tp(q, t), torch.from_numpy(pts)), jse3.act(J(q, t), jnp.asarray(pts)))


def test_relative_pose_jacobians_and_distance():
    rng = np.random.RandomState(3)
    qa, ta = rand_poses(rng, 12)
    qb, tb = rand_poses(rng, 12)
    rj = jax.vmap(jse3.relative_pose_jacobians)(J(qa, ta), J(qb, tb))
    rt = tse3.relative_pose_jacobians(Tp(qa, ta), Tp(qb, tb))
    close(rt[0].q, rj[0].q)
    close(rt[0].t, rj[0].t)
    close(rt[1], rj[1])
    close(rt[2], rj[2])
    close(tse3.pose_distance(Tp(qa, ta), Tp(qb, tb)),
          jse3.pose_distance(J(qa, ta), J(qb, tb)), 1e-4)
    close(tse3.pose_distance(Tp(qa, ta), Tp(qb, tb), 1.0, 0.0),
          jse3.pose_distance(J(qa, ta), J(qb, tb), 1.0, 0.0))
    pts = rng.standard_normal((12, 3)).astype(np.float32)
    close(tse3.transform_jacobian_pose(torch.from_numpy(pts), Tp(qa, ta)),
          jse3.transform_jacobian_pose(jnp.asarray(pts), J(qa, ta)))


def test_camera_and_pyramid():
    rng = np.random.RandomState(4)
    cj, ct = jcm.PinholeCamera.create(**CAM), tcm.PinholeCamera.create(**CAM)
    for a, b in zip(tcm.camera_pyramid(ct, 4), jcm.camera_pyramid(cj, 4)):
        np.testing.assert_allclose(np.array(a, np.float64),
                                   np.array([float(x) for x in b]), rtol=1e-6)
    pix = rng.uniform(0, 300, (30, 2)).astype(np.float32)
    dpt = rng.uniform(0.5, 5, 30).astype(np.float32)
    pt = rng.uniform(0.2, 3, (30, 3)).astype(np.float32)
    T = torch.from_numpy
    close(tcm.project(ct, T(pt)), jcm.project(cj, jnp.asarray(pt)), 1e-4)
    close(tcm.reproject(ct, T(pix), T(dpt)), jcm.reproject(cj, jnp.asarray(pix), jnp.asarray(dpt)))
    close(tcm.project_point_jacobian(ct, T(pt)),
          jcm.project_point_jacobian(cj, jnp.asarray(pt)), 1e-3)
    close(tcm.reproject_pixel_jacobian(ct, T(pix), T(dpt)),
          jcm.reproject_pixel_jacobian(cj, jnp.asarray(pix), jnp.asarray(dpt)))
    np.testing.assert_array_equal(tcm.pixel_valid(ct, T(pix), 2).numpy(),
                                  np.asarray(jcm.pixel_valid(cj, jnp.asarray(pix), 2)))


def test_warping_matches_jax():
    rng = np.random.RandomState(5)
    cj, ct = jcm.PinholeCamera.create(**CAM), tcm.PinholeCamera.create(**CAM)
    q, t = rand_poses(rng, 1, 0.05, 0.05)
    pj, pt_ = J(q[0], t[0]), Tp(q[0], t[0])
    pix = rng.uniform(0, 320, (50, 2)).astype(np.float32)
    dpt = rng.uniform(1, 4, 50).astype(np.float32)
    jac = rng.standard_normal((50, 8)).astype(np.float32)
    T = torch.from_numpy
    cj_ = jwp.find_correspondence(jnp.asarray(pix), jnp.asarray(dpt), cj, pj)
    ct_ = twp.find_correspondence(T(pix), T(dpt), ct, pt_)
    close(ct_.pix1, cj_.pix1, 1e-3)
    np.testing.assert_array_equal(ct_.valid.numpy(), np.asarray(cj_.valid))
    close(twp.correspondence_jacobian_pose(ct_, T(dpt), ct, pt_),
          jwp.correspondence_jacobian_pose(cj_, jnp.asarray(dpt), cj, pj), 1e-3)
    close(twp.correspondence_jacobian_code(ct_, T(dpt), ct, pt_, T(jac), 2.0),
          jwp.correspondence_jacobian_code(cj_, jnp.asarray(dpt), cj, pj,
                                           jnp.asarray(jac), 2.0), 1e-3)
    close(twp.depth_to_prox(T(dpt), 2.0), jwp.depth_to_prox(jnp.asarray(dpt), 2.0))
    close(twp.depth_jacobian_prx(T(dpt), 2.0), jwp.depth_jacobian_prx(jnp.asarray(dpt), 2.0), 1e-4)


@pytest.mark.parametrize("fn", ["huber_weight", "tukey_weight", "cauchy_weight",
                                "tukey_sqrt_weight"])
def test_m_estimators(fn):
    x = np.linspace(-1, 1, 101).astype(np.float32)
    close(getattr(tme, fn)(torch.from_numpy(x), 0.3), getattr(jme, fn)(jnp.asarray(x), 0.3))


def test_correspondence_jacobians_finite_diff():
    """tests/test_warping.py's FD checks (pose, depth), on the port in f64."""
    rng = np.random.RandomState(7)
    cam = tcm.PinholeCamera.create(**CAM)
    w = torch.tensor(rng.uniform(-0.05, 0.05, 3))
    pose = tse3.SE3(tse3.so3_exp_quat(w), torch.tensor(rng.uniform(-0.05, 0.05, 3)))
    pix0 = torch.tensor(rng.uniform(40, 180, (30, 2)))
    dpt = torch.tensor(rng.uniform(1.0, 4.0, 30))
    c = twp.find_correspondence(pix0, dpt, cam, pose, check_bounds=False)
    jac = twp.correspondence_jacobian_pose(c, dpt, cam, pose)
    eps = 1e-6
    for i in range(6):
        d = torch.zeros(6, dtype=torch.float64)
        d[i] = eps
        cp = twp.find_correspondence(pix0, dpt, cam, tse3.retract(pose, d), check_bounds=False)
        cn = twp.find_correspondence(pix0, dpt, cam, tse3.retract(pose, -d), check_bounds=False)
        num = (cp.pix1 - cn.pix1) / (2 * eps)
        np.testing.assert_allclose(jac[..., :, i].numpy(), num.numpy(), atol=1e-4, rtol=1e-5)
    jd = twp.correspondence_jacobian_depth(c, dpt, cam, pose)
    cp = twp.find_correspondence(pix0, dpt + eps, cam, pose, check_bounds=False)
    cn = twp.find_correspondence(pix0, dpt - eps, cam, pose, check_bounds=False)
    np.testing.assert_allclose(jd.numpy(), ((cp.pix1 - cn.pix1) / (2 * eps)).numpy(),
                               atol=1e-4, rtol=1e-5)
    pt = torch.tensor(rng.uniform(0.2, 2.0, (10, 3)))
    jp = tcm.project_point_jacobian(cam, pt)
    for k in range(3):
        d = torch.zeros(3, dtype=torch.float64)
        d[k] = eps
        num = (tcm.project(cam, pt + d) - tcm.project(cam, pt - d)) / (2 * eps)
        np.testing.assert_allclose(jp[..., :, k].numpy(), num.numpy(), atol=1e-3, rtol=1e-5)


def test_relative_pose_jacobians_finite_diff():
    rng = np.random.RandomState(8)
    mk = lambda: tse3.SE3(tse3.so3_exp_quat(torch.tensor(rng.uniform(-.5, .5, 3))),
                          torch.tensor(rng.uniform(-.5, .5, 3)))
    a, b = mk(), mk()
    rel, ja, jb = tse3.relative_pose_jacobians(a, b)
    eps = 1e-6
    for which, J_ in (("a", ja), ("b", jb)):
        for i in range(6):
            d = torch.zeros(6, dtype=torch.float64)
            d[i] = eps
            if which == "a":
                rp, rn = (tse3.relative_pose(tse3.retract(a, s * d), b) for s in (1, -1))
            else:
                rp, rn = (tse3.relative_pose(a, tse3.retract(b, s * d)) for s in (1, -1))
            num = (tse3.local(rel, rp) - tse3.local(rel, rn)) / (2 * eps)
            np.testing.assert_allclose(J_[:, i].numpy(), num.numpy(), atol=1e-6)
