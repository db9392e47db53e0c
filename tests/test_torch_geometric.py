"""The sparse geometric factor of deepfactors_tpu_torch
(``ops/sparse_factors.geometric_system`` / ``geometric_error``) and the
uniform point sampler (``features/sampler.py``) against the JAX package, on
the same inputs made from a numpy seed: two 48x64 keyframes with smooth
zero-code prox images and code Jacobians of CS = 4 and 8 channels, keyframe
1's depth gradient from the Sobel filter of its decoded depth (as the map
state writes it), N = 32 points, and a relative pose far enough from the
identity that residuals are far from zero and a few points leave the image.

Tolerances, both packages in fp32 on the CPU:
  - the validity masks identical, and the nearest-pixel lookups at the
    projected pixel land on the same pixel for every point (the inputs
    keep every projected coordinate at least 1e-4 px from an integer, so
    round-off cannot move a lookup);
  - JtJ and Jtr within 1e-4 of each block's largest entry, blocks
    [pose0 | pose1 | code0 | code1] (the expressions are the same; the
    Jacobian chains and the (N x D) reduction run in another order), the
    residual within 1e-4 relative, the inlier count exactly;
  - ``geometric_error`` within 1e-5 relative;
  - the batched forms (P factors with a leading axis, and the mapper's
    form reading the keyframe pools through ``src`` / ``dst``) equal to P
    single calls within 1e-6 of the largest entry;
  - the port's code1 gradient against central finite differences of its
    own residual, as tests/test_sparse_factors.py:139 holds the JAX one
    (rtol 5e-2, atol 2e-3: fp32 differences with a step of 1e-4);
  - the sampler: every point inside [border, size - 1 - border), and the
    mapper's ``geo_draw`` hook replays JAX's ``sample_uniform_pixels``
    draws bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfactors_tpu.features import sampler as jsmp
from deepfactors_tpu.geometry import se3 as jse3
from deepfactors_tpu.geometry.camera import PinholeCamera as JCam
from deepfactors_tpu.ops import sparse_factors as jsf
from deepfactors_tpu_torch.features import sampler as tsmp
from deepfactors_tpu_torch.geometry import se3 as tse3
from deepfactors_tpu_torch.geometry import warping as twp
from deepfactors_tpu_torch.geometry.camera import PinholeCamera as TCam
from deepfactors_tpu_torch.geometry.se3 import SE3 as TSE3
from deepfactors_tpu_torch.ops import image as tip
from deepfactors_tpu_torch.ops import sparse_factors as tsf

torch.set_num_threads(2)
H, W, N = 48, 64, 32
TOL = 1e-4
ERR_RTOL = 1e-5
BATCH_TOL = 1e-6
CAM = dict(fx=55.0, fy=55.0, u0=W / 2, v0=H / 2, width=W, height=H)


def _keyframe(CS, k):
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    prx0 = (0.5 + 0.04 * np.sin(xs / (11 + k)) * np.cos(ys / (9 + k))
            ).astype(np.float32)
    jac = np.stack([0.02 * np.sin(xs / (7 + c + k) + c) * np.cos(ys / (6 + c))
                    for c in range(CS)]).astype(np.float32)
    return prx0, jac


def _inputs(CS, seed=4):
    rng = np.random.RandomState(seed)
    prx0a, jaca = _keyframe(CS, 0)
    prx0b, jacb = _keyframe(CS, 3)
    code0 = rng.uniform(-0.4, 0.4, CS).astype(np.float32)
    code1 = rng.uniform(-0.4, 0.4, CS).astype(np.float32)
    # keyframe 1's depth gradient as the map state writes it: the Sobel
    # filter of its decoded level-0 depth
    dpt1 = twp.depth_from_code(torch.from_numpy(code1),
                               torch.from_numpy(jacb).permute(1, 2, 0),
                               torch.from_numpy(prx0b), 2.0)
    dgrad = tip.sobel_gradients(dpt1).numpy()
    pts = np.stack([rng.uniform(1, W - 2, N), rng.uniform(1, H - 2, N)],
                   -1).astype(np.float32)
    d0 = rng.uniform(-0.02, 0.02, 6).astype(np.float32)
    d1 = np.asarray([0.12, -0.05, 0.08, 0.02, -0.03, 0.015], np.float32)
    return dict(prx0a=prx0a, jaca=jaca, prx0b=prx0b, jacb=jacb, code0=code0,
                code1=code1, dgrad=dgrad, pts=pts, d0=d0, d1=d1)


def _poses(s, se3, SE):
    ident = SE(np.array([1.0, 0, 0, 0], np.float32), np.zeros(3, np.float32))
    to = (jnp.asarray if SE is jse3.SE3 else torch.from_numpy)
    ident = SE(to(ident.q), to(ident.t))
    return se3.retract(ident, to(s["d0"])), se3.retract(ident, to(s["d1"]))


def _jax(s, fn, **kw):
    p0, p1 = _poses(s, jse3, jse3.SE3)
    a = jnp.asarray
    args = [p0, p1, a(s["code0"]), a(s["code1"]), JCam.create(**CAM),
            a(s["pts"]), a(s["prx0a"]), a(s["jaca"]), a(s["prx0b"]),
            a(s["jacb"])]
    if fn is jsf.geometric_system:
        args.append(a(s["dgrad"]))
    return fn(*args, **kw)


def _torch(s, fn, **kw):
    p0, p1 = _poses(s, tse3, TSE3)
    t = torch.from_numpy
    args = [p0, p1, t(s["code0"]), t(s["code1"]), TCam.create(**CAM),
            t(s["pts"]), t(s["prx0a"]), t(s["jaca"]), t(s["prx0b"]),
            t(s["jacb"])]
    if fn is tsf.geometric_system:
        args.append(t(s["dgrad"]))
    return fn(*args, **kw)


def block_close(a, b, CS, tol=TOL):
    """JtJ [D, D] or Jtr [D] of the two packages within tol of each block's
    largest entry, blocks [pose0 | pose1 | code0 | code1]."""
    edges = np.cumsum([0, 6, 6, CS, CS])
    sl = [slice(edges[i], edges[i + 1]) for i in range(4)]
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    blocks = ([(i, j) for i in sl for j in sl] if a.ndim == 2
              else [(i,) for i in sl])
    for blk in blocks:
        scale = max(np.abs(b[blk]).max(), 1e-30)
        np.testing.assert_allclose(a[blk], b[blk], rtol=0, atol=tol * scale,
                                   err_msg=str(blk))


def _one(p):
    return TSE3(p.q[None], p.t[None])


def _jax_lookups(s):
    """The projected pixels of the points and their validity, as the JAX
    system computes them (border 1, min depth 0)."""
    from deepfactors_tpu.geometry import warping as jwp
    p0, p1 = _poses(s, jse3, jse3.SE3)
    a = jnp.asarray
    prx, jac = jsf._sample_code_data(a(s["prx0a"]), a(s["jaca"]), a(s["pts"]))
    dpt0 = jwp.depth_from_code(a(s["code0"]), jac, prx, 2.0)
    corr = jwp.find_correspondence(a(s["pts"]), dpt0, JCam.create(**CAM),
                                   jse3.relative_pose(p1, p0), border=1,
                                   min_dpt=0.0)
    return np.asarray(corr.pix1), np.asarray(corr.valid)


def _torch_lookups(s):
    p0, p1 = _poses(s, tse3, TSE3)
    t = lambda k: torch.from_numpy(s[k])[None]
    *_, corr, _, _ = tsf._geo_warp(
        _one(p0), _one(p1), t("code0"), t("code1"), TCam.create(**CAM),
        t("pts"), t("prx0a"), t("jaca"), t("prx0b"), t("jacb"), 2.0, None,
        None, border=1, min_dpt=0.0)
    return corr.pix1[0].numpy(), corr.valid[0].numpy()


@pytest.mark.parametrize("CS", [4, 8])
def test_geometric_system_matches_jax(CS):
    s = _inputs(CS)
    sj = _jax(s, jsf.geometric_system, huber_delta=0.1)
    st = _torch(s, tsf.geometric_system, huber_delta=0.1)
    pj, vj = _jax_lookups(s)
    pt, vt = _torch_lookups(s)
    np.testing.assert_array_equal(vt, vj)
    # the nearest-pixel lookups: far from an integer, so on the same pixel
    frac = np.abs(pj - np.round(pj))
    assert frac[vj].min() > 1e-4, frac[vj].min()
    np.testing.assert_array_equal(pt.astype(np.int32), pj.astype(np.int32))
    # residuals far from zero, some points out of the image
    assert float(sj.residual) > 1e-3
    assert 0 < int(sj.inliers) < N
    assert float(st.inliers) == float(sj.inliers)
    block_close(st.JtJ.numpy(), sj.JtJ, CS)
    block_close(st.Jtr.numpy(), sj.Jtr, CS)
    np.testing.assert_allclose(float(st.residual), float(sj.residual),
                               rtol=TOL)
    assert st.JtJ.shape == (12 + 2 * CS, 12 + 2 * CS)


@pytest.mark.parametrize("huber", [0.1, 1e6])
def test_geometric_error_matches_jax(huber):
    s = _inputs(4)
    ej = float(_jax(s, jsf.geometric_error, huber_delta=huber))
    et = float(_torch(s, tsf.geometric_error, huber_delta=huber))
    assert ej > 1e-4
    np.testing.assert_allclose(et, ej, rtol=ERR_RTOL)


def test_geometric_batched_and_pool_forms_equal_single_calls():
    """P = 3 factors between 3 keyframes: with a leading axis, and reading
    the keyframe pools through src / dst, against 3 single calls."""
    CS, P = 4, 3
    ss = [_inputs(CS, seed) for seed in (4, 5, 6)]
    cam = TCam.create(**CAM)
    t = torch.from_numpy
    singles = [_torch(s, tsf.geometric_system) for s in ss]
    pz = [_poses(s, tse3, TSE3) for s in ss]
    pose0 = tse3.stack([p[0] for p in pz])
    pose1 = tse3.stack([p[1] for p in pz])
    st = lambda k: torch.stack([t(s[k]) for s in ss])
    batched = tsf.geometric_system(
        pose0, pose1, st("code0"), st("code1"), cam, st("pts"), st("prx0a"),
        st("jaca"), st("prx0b"), st("jacb"), st("dgrad"))
    # pools: slot 2p holds factor p's keyframe 0, slot 2p+1 its keyframe 1
    pool = lambda a, b: torch.stack([t(s[k]) for s in ss for k in (a, b)])
    src = torch.arange(0, 2 * P, 2)
    dst = src + 1
    dg = torch.stack([torch.zeros(H, W, 2) if k == "z" else t(s[k])
                      for s in ss for k in ("z", "dgrad")])
    pooled = tsf.geometric_system(
        pose0, pose1, st("code0"), st("code1"), cam, st("pts"),
        pool("prx0a", "prx0b"), pool("jaca", "jacb"),
        pool("prx0a", "prx0b"), pool("jaca", "jacb"), dg, src=src, dst=dst)
    for form in (batched, pooled):
        for p, one in enumerate(singles):
            for a, b in zip(form, one):
                b = b.numpy()
                scale = max(np.abs(b).max(), 1e-30)
                np.testing.assert_allclose(a[p].numpy(), b, rtol=0,
                                           atol=BATCH_TOL * scale)
    errs = tsf.geometric_error(
        pose0, pose1, st("code0"), st("code1"), cam, st("pts"), st("prx0a"),
        st("jaca"), st("prx0b"), st("jacb"))
    for p, s in enumerate(ss):
        np.testing.assert_allclose(float(errs[p]),
                                   float(_torch(s, tsf.geometric_error)),
                                   rtol=BATCH_TOL)


def test_geometric_jtr_code1_finite_diff():
    """The code1 block of the port's Jtr against central differences of its
    own residual (Huber off; keyframe 1's depth gradient is irrelevant to
    the code1 derivative)."""
    CS = 6
    s = _inputs(CS, seed=7)
    cam = TCam.create(**CAM)
    p0, p1 = _poses(s, tse3, TSE3)
    t = torch.from_numpy

    def resid(c1):
        *_, corr, _, dpt1 = tsf._geo_warp(
            _one(p0), _one(p1),
            t(s["code0"])[None], c1[None], cam, t(s["pts"])[None],
            t(s["prx0a"])[None], t(s["jaca"])[None], t(s["prx0b"])[None],
            t(s["jacb"])[None], 2.0, None, None)
        r = dpt1 - corr.tpt[..., 2]
        return torch.where(corr.valid, r, torch.zeros_like(r))[0].numpy()

    code1 = t(s["code1"])
    sys = _torch(s, tsf.geometric_system, huber_delta=1e6)
    r0 = resid(code1)
    eps = 1e-4
    num = np.zeros(CS)
    for k in range(CS):
        dd = torch.zeros(CS)
        dd[k] = eps
        num[k] = float(np.sum((resid(code1 + dd) - resid(code1 - dd))
                              / (2 * eps) * r0))
    np.testing.assert_allclose(sys.Jtr[12 + CS:].numpy(), num, rtol=5e-2,
                               atol=2e-3)
    assert np.abs(num).max() > 1e-2


@pytest.mark.parametrize("border", [1, 3])
def test_sampler_range(border):
    g = torch.Generator().manual_seed(3)
    pts = tsmp.sample_uniform_pixels(5000, W, H, border, g)
    assert pts.shape == (5000, 2) and pts.dtype == torch.float32
    x, y = pts[:, 0].numpy(), pts[:, 1].numpy()
    assert x.min() >= border and x.max() < W - 1 - border
    assert y.min() >= border and y.max() < H - 1 - border
    # uniform: each half of the range holds about half the points
    assert abs((x < (W - 1) / 2).mean() - 0.5) < 0.05
    again = tsmp.sample_uniform_pixels(
        5000, W, H, border, torch.Generator().manual_seed(3))
    assert torch.equal(pts, again)


def test_geo_draw_hook_replays_jax():
    """The shared key chain's geo draws are JAX's ``sample_uniform_pixels``
    draws from the same keys, bit for bit."""
    from test_torch_mapper_rep import JaxKeyChain

    chain = JaxKeyChain()
    key = jax.random.PRNGKey(42)
    for _ in range(3):
        key, k = jax.random.split(key)
        ref = np.asarray(jsmp.sample_uniform_pixels(k, N, W, H))
        np.testing.assert_array_equal(chain.geo(N, W, H), ref)
