"""ops/sparse_factors.py (the reprojection factor) of deepfactors_tpu_torch
against the JAX package's, on the same inputs made from a numpy seed: a
64x96 keyframe with a smooth zero-code prox image and a code Jacobian of
CS = 4 and 32 channels, M = 128 matches of which a quarter are invalid, and
one keypoint whose point lies behind the second camera (its match is
valid, its row is dropped by the depth test).

Tolerances, both packages in fp32 on the CPU. The warp and its Jacobians
are the same expressions; they differ only in how the (2M x D) Jacobian
rows are reduced (XLA's dot against PyTorch's matmul), so JtJ and Jtr are
held within 1e-5 of each block's largest entry, the residual and the cost
of ``reprojection_error`` within 1e-5 relative, the inlier count exactly,
and NaN (none expected here) in the same places. The batched form (P
factors with a leading axis, and the mapper's form reading the keyframe
pools through ``src``) must equal P single calls to 1e-6 of the largest
entry. The port's Jtr is also held against central finite differences of
its own residual, as tests/test_sparse_factors.py holds the JAX one (5e-2:
the differences are taken in fp32 with a step of 1e-4)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfactors_tpu.geometry import se3 as jse3
from deepfactors_tpu.geometry.camera import PinholeCamera as JCam
from deepfactors_tpu.ops import sparse_factors as jsf
from deepfactors_tpu_torch.geometry import se3 as tse3
from deepfactors_tpu_torch.geometry.camera import PinholeCamera as TCam
from deepfactors_tpu_torch.geometry.se3 import SE3 as TSE3
from deepfactors_tpu_torch.ops import sparse_factors as tsf

torch.set_num_threads(2)
H, W, M = 64, 96, 128
TOL = 1e-5
CAM = dict(fx=80.0, fy=80.0, u0=W / 2, v0=H / 2, width=W, height=H)


def _inputs(CS, seed=4):
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    # deep scene (prox 0.15 -> depth ~11 m) so a 3 m forward step keeps it
    # in front of the second camera, except one near keypoint (prox 0.6)
    prx0 = (0.15 + 0.01 * np.sin(xs / 11) * np.cos(ys / 9)).astype(np.float32)
    jac = np.stack([0.005 * np.sin(xs / (7 + k) + k) * np.cos(ys / (6 + k))
                    for k in range(CS)]).astype(np.float32)
    kp0 = rng.uniform(10, 80, (M, 2)).astype(np.float32)
    kp0[:, 1] = np.clip(kp0[:, 1], 4, H - 5)
    near = (int(kp0[0, 1]), int(kp0[0, 0]))
    prx0[near] = 0.6
    kp1 = kp0 + rng.uniform(-3, 3, (M, 2)).astype(np.float32)
    valid = rng.uniform(size=M) > 0.25
    valid[0] = True
    d0 = rng.uniform(-0.02, 0.02, 6).astype(np.float32)
    d1 = np.asarray([0.03, -0.02, 3.0, 0.01, -0.008, 0.012], np.float32)
    code = rng.uniform(-0.5, 0.5, CS).astype(np.float32)
    return dict(prx0=prx0, jac=jac, kp0=kp0, kp1=kp1, valid=valid, d0=d0,
                d1=d1, code=code)


def _jax(s, fn):
    p0 = jse3.retract(jse3.identity(), jnp.asarray(s["d0"]))
    p1 = jse3.retract(jse3.identity(), jnp.asarray(s["d1"]))
    return fn(p0, p1, jnp.asarray(s["code"]), JCam.create(**CAM),
              jnp.asarray(s["kp0"]), jnp.asarray(s["kp1"]),
              jnp.asarray(s["valid"]), jnp.asarray(s["prx0"]),
              jnp.asarray(s["jac"]), huber_delta=0.1, sigma=1.0, avg_dpt=2.0)


def _torch(s, fn):
    t = lambda a: torch.from_numpy(np.asarray(a))
    p0 = tse3.retract(tse3.identity(device="cpu"), t(s["d0"]))
    p1 = tse3.retract(tse3.identity(device="cpu"), t(s["d1"]))
    return fn(p0, p1, t(s["code"]), TCam.create(**CAM),
              t(s["kp0"]), t(s["kp1"]), t(s["valid"]), t(s["prx0"]),
              t(s["jac"]), huber_delta=0.1, sigma=1.0, avg_dpt=2.0)


def _close(a, b, tol=TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    scale = np.nanmax(np.abs(b))
    np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b),
                               atol=tol * scale, rtol=0)


def test_inputs_hold_a_point_behind_the_second_camera():
    s = _inputs(4)
    t = lambda a: torch.from_numpy(np.asarray(a))
    p0 = tse3.retract(tse3.identity(device="cpu"), t(s["d0"]))
    p1 = tse3.retract(tse3.identity(device="cpu"), t(s["d1"]))
    _, dpt0, _, corr = tsf._warp(
        TSE3(p0.q[None], p0.t[None]), TSE3(p1.q[None], p1.t[None]),
        t(s["code"])[None], TCam.create(**CAM), t(s["kp0"])[None],
        t(s["prx0"])[None], t(s["jac"])[None], 2.0)
    behind = (corr.tpt[0, :, 2] <= 0).numpy()
    assert behind[0] and behind.sum() == 1
    assert (dpt0 > 0).all()


@pytest.mark.parametrize("CS", [4, 32])
def test_reprojection_system_matches_jax(CS):
    s = _inputs(CS)
    a = _torch(s, tsf.reprojection_system)
    b = _jax(s, jsf.reprojection_system)
    _close(a.JtJ, b.JtJ)
    _close(a.Jtr, b.Jtr)
    np.testing.assert_allclose(float(a.residual), float(b.residual), rtol=TOL)
    assert float(a.inliers) == float(b.inliers) == 2 * (s["valid"].sum() - 1)


@pytest.mark.parametrize("CS", [4, 32])
def test_reprojection_error_matches_jax(CS):
    s = _inputs(CS)
    a = float(_torch(s, tsf.reprojection_error))
    b = float(_jax(s, jsf.reprojection_error))
    assert np.isfinite(b) and b > 0
    np.testing.assert_allclose(a, b, rtol=TOL)


def test_batched_and_pool_forms_equal_single_calls():
    P, CS = 3, 4
    ss = [_inputs(CS, seed=10 + i) for i in range(P)]
    single = [_torch(s, tsf.reprojection_system) for s in ss]
    st = lambda k: torch.stack([torch.from_numpy(np.asarray(s[k])) for s in ss])
    ident = tse3.identity(device="cpu")
    p0 = tse3.retract(TSE3(ident.q.expand(P, 4), ident.t.expand(P, 3)), st("d0"))
    p1 = tse3.retract(TSE3(ident.q.expand(P, 4), ident.t.expand(P, 3)), st("d1"))
    args = (p0, p1, st("code"), TCam.create(**CAM), st("kp0"), st("kp1"),
            st("valid"))
    batched = tsf.reprojection_system(*args, st("prx0"), st("jac"))
    # the mapper's form: images in a pool of 5 slots, factor p in slot 4 - p
    order = [4, 3, 2]
    prx_pool = torch.zeros((5, H, W))
    jac_pool = torch.zeros((5, CS, H, W))
    prx_pool[order] = st("prx0")
    jac_pool[order] = st("jac")
    pooled = tsf.reprojection_system(*args, prx_pool, jac_pool,
                                     src=torch.tensor(order))
    for out in (batched, pooled):
        for p in range(P):
            _close(out.JtJ[p], single[p].JtJ, 1e-6)
            _close(out.Jtr[p], single[p].Jtr, 1e-6)
            assert float(out.inliers[p]) == float(single[p].inliers)


def test_reprojection_jtr_finite_diff():
    """The port's mirror of tests/test_sparse_factors.py's check, on its
    inputs (seed 4, CS 6, 24 matches, pose0 at the identity): with a huge
    Cauchy delta every weight is 1/sqrt(2), so Jtr = 0.5 Jᵀr."""
    CS, Mf = 6, 24
    rng = np.random.RandomState(4)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    prx0 = (0.5 + 0.04 * np.sin(xs / 11) * np.cos(ys / 9)).astype(np.float32)
    jac = np.stack([0.02 * np.sin(xs / (7 + k) + k) * np.cos(ys / (6 + k))
                    for k in range(CS)]).astype(np.float32)
    kp0 = rng.uniform(10, 80, (Mf, 2)).astype(np.float32)
    kp1 = kp0 + rng.uniform(-3, 3, (Mf, 2)).astype(np.float32)
    d1 = np.asarray([0.03, -0.02, 0.04, 0.01, -0.008, 0.012], np.float32)
    code = rng.uniform(-0.5, 0.5, CS).astype(np.float32)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    cam = TCam.create(**CAM)
    base0 = tse3.identity(device="cpu")
    base1 = tse3.retract(base0, t(d1))

    def resid(p0, p1, c):
        *_, corr = tsf._warp(TSE3(p0.q[None], p0.t[None]),
                             TSE3(p1.q[None], p1.t[None]), t(c)[None], cam,
                             t(kp0)[None], t(prx0)[None], t(jac)[None], 2.0)
        return (t(kp1) - corr.pix1[0]).reshape(-1).numpy()

    sys_ = tsf.reprojection_system(
        base0, base1, t(code), cam, t(kp0), t(kp1),
        torch.ones(Mf, dtype=torch.bool), t(prx0), t(jac), huber_delta=1e6,
        sigma=1.0)
    r0 = resid(base0, base1, code)
    eps = 1e-4
    num = np.zeros(12 + CS)
    for i in range(12 + CS):
        rs = []
        for sgn in (1.0, -1.0):
            dd = np.zeros(12 + CS, np.float32)
            dd[i] = sgn * eps
            rs.append(resid(tse3.retract(base0, t(dd[:6])),
                            tse3.retract(base1, t(dd[6:12])), code + dd[12:]))
        num[i] = 0.5 * float(np.sum((rs[0] - rs[1]) / (2 * eps) * r0))
    np.testing.assert_allclose(sys_.Jtr.numpy(), num, rtol=5e-2, atol=5e-2)


def test_sample_code_data_truncates_like_jax():
    """The nearest-pixel lookup casts toward zero and clamps, as the JAX
    package does (reprojection_factor.cpp:195-198)."""
    s = _inputs(4)
    pix = np.asarray([[0.7, 0.2], [-3.5, 5.9], [W + 2.0, H - 0.5],
                      [12.999, 40.01]], np.float32)
    a = tsf._sample_code_data(torch.from_numpy(s["prx0"])[None],
                              torch.from_numpy(s["jac"])[None],
                              torch.from_numpy(pix)[None])
    b = jsf._sample_code_data(jnp.asarray(s["prx0"]), jnp.asarray(s["jac"]),
                              jnp.asarray(pix))
    np.testing.assert_array_equal(a[0][0].numpy(), np.asarray(b[0]))
    np.testing.assert_array_equal(a[1][0].numpy(), np.asarray(b[1]))
