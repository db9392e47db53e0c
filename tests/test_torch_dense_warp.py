"""The unfused sampled-gradient linearisation of the port against the JAX
package: the plain PyTorch twins of the dense-warp kernels
(deepfactors_tpu_torch/ops/kernels/dense_warp.py) against
``ops/pallas/warp_kernel.py`` (its Pallas kernels in interpret mode and its
XLA reference), then ``dense_sfm.sfm_step`` / ``sfm_step_batch`` with
sampled Sobel gradients, ``depth_align_step(_T)`` and
``factors.depth_prior_batch`` against their JAX counterparts. Inputs are
numpy, seeded, identical for both packages; sizes satisfy the Pallas tile
rule (H % 8 == 0, W % 128 == 0) where a Pallas kernel runs.

Tolerances: samples 1e-5 absolute (fp32, and the XLA reference interpolates
as v00*(1-w) + v01*w where the kernels use v00 + w*(v01 - v00)); transformed
points 1e-5; ``valid`` equal except within 1e-4 of a border; params rows
1e-6; GN systems 1e-4 of max|JtJ| (another summation order), inlier counts
exact; depth alignment 1e-5 of the largest entry."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_sfm_gram import T, cams, make_problem, rel_err

from deepfactors_tpu.geometry import se3 as jse3
from deepfactors_tpu.geometry.se3 import SE3 as JSE3
from deepfactors_tpu.mapping import factors as jfct
from deepfactors_tpu.mapping import map_state as jms
from deepfactors_tpu.ops import dense_sfm as jds
from deepfactors_tpu.ops.image import bilinear_sample
from deepfactors_tpu.ops.pallas import warp_kernel as jwk
from deepfactors_tpu_torch.geometry import se3 as tse3
from deepfactors_tpu_torch.geometry.se3 import SE3 as TSE3
from deepfactors_tpu_torch.mapping import factors as tfct
from deepfactors_tpu_torch.mapping import map_state as tms
from deepfactors_tpu_torch.ops import dense_sfm as tds
from deepfactors_tpu_torch.ops.kernels import dense_warp as tdw

torch.set_num_threads(2)
H, W = 32, 128
ATOL = 1e-5
TOL = 1e-4


@pytest.fixture
def xla_warp():
    """The JAX package on its XLA sampling path (its default on a CPU),
    whatever an earlier test left the switch at."""
    prev = jds.use_pallas_warp()
    jds.use_pallas_warp(False)
    yield
    jds.use_pallas_warp(prev)


def _coords():
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    return (xs + 2.0 * np.sin(ys / 10) + 0.7).astype(np.float32), \
        (ys + 1.5 * np.cos(xs / 15) - 0.3).astype(np.float32)


def test_bilinear_warp_planes_plain_matches_jax():
    """Against the XLA reference everywhere (the coordinates leave the
    image on three sides), and against the Pallas kernel in interpret mode
    where its band covers the pixel."""
    chans = np.random.RandomState(0).rand(3, H, W).astype(np.float32)
    x1, y1 = _coords()
    out = tdw.bilinear_warp_planes(T(chans), T(x1), T(y1)).numpy()
    ref, _ = jwk.bilinear_warp_reference(jnp.asarray(chans), jnp.asarray(x1),
                                         jnp.asarray(y1))
    assert out.shape == (3, H, W)
    assert (x1 > W - 1).any() and (y1 < 0).any() and (y1 > H - 1).any()
    np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL)
    pal, cover = jwk.bilinear_warp_planes(jnp.asarray(chans), jnp.asarray(x1),
                                          jnp.asarray(y1), band=16,
                                          interpret=True)
    c = np.asarray(cover) > 0.5
    assert c.mean() > 0.9
    assert np.abs(out - np.asarray(pal))[:, c].max() < ATOL


def test_bilinear_weight_is_zero_at_the_last_row_and_column():
    """At x in [W-1, W) the +1 neighbour is the edge pixel itself: the
    sample is the edge value, not a blend with anything else; the same in
    y. Far outside, and at non-finite coordinates, the read stays inside
    the plane."""
    chans = np.random.RandomState(1).rand(2, H, W).astype(np.float32)
    x1 = np.full((H, W), W - 0.5, np.float32)
    y1 = np.tile(np.arange(H, dtype=np.float32)[:, None], (1, W))
    out = tdw.bilinear_warp_planes(T(chans), T(x1), T(y1)).numpy()
    np.testing.assert_array_equal(out, np.repeat(chans[:, :, -1:], W, axis=2))
    xs = np.tile(np.arange(W, dtype=np.float32)[None], (H, 1))
    out = tdw.bilinear_warp_planes(T(chans), T(xs),
                                   T(np.full((H, W), H - 0.25, np.float32)))
    np.testing.assert_array_equal(out.numpy(),
                                  np.repeat(chans[:, -1:, :], H, axis=1))
    far = np.full((H, W), 3e38, np.float32)
    far[0, :4] = [-3e38, np.inf, -np.inf, np.nan]
    out = tdw.bilinear_warp_planes(T(chans), T(far), T(y1)).numpy()
    assert out.shape == (2, H, W)
    np.testing.assert_array_equal(out[:, 1:], np.repeat(chans[:, 1:, -1:], W, 2))
    assert np.isfinite(out[:, 0, :2]).all()


def _plane_list(C, Hs, Ws, seed):
    """C planes [Hs, Ws] as a caller holds them: img1 (contiguous), the two
    channels of an interleaved gradient [Hs, Ws, 2] (stride 2) and, beyond
    three, channels 0 and 2 of an [Hs, Ws, 3] array (stride 3)."""
    rng = np.random.RandomState(seed)
    img = T(rng.rand(Hs, Ws).astype(np.float32))
    grad = T(rng.standard_normal((Hs, Ws, 2)).astype(np.float32))
    more = T(rng.rand(Hs, Ws, 3).astype(np.float32))
    planes = [img, grad[..., 0], grad[..., 1], more[..., 0], more[..., 2]]
    return planes[:C]


def _coords_all_sides(Hs, Ws, seed, special=True):
    """Coordinates that leave the image on all four sides; with
    ``special``, also +-inf, NaN and +-3e38 in the first row."""
    rng = np.random.RandomState(seed)
    x1 = rng.uniform(-3.0, Ws + 2.0, (Hs, Ws)).astype(np.float32)
    y1 = rng.uniform(-3.0, Hs + 2.0, (Hs, Ws)).astype(np.float32)
    assert (x1 < 0).any() and (x1 > Ws - 1).any()
    assert (y1 < 0).any() and (y1 > Hs - 1).any()
    if special:
        odd = np.array([np.inf, -np.inf, np.nan, 3e38, -3e38], np.float32)
        x1[0, :5] = odd
        y1[0, 5:10] = odd
        x1[0, 10:15], y1[0, 10:15] = odd, odd[::-1]
    return x1, y1


@pytest.mark.parametrize("Hs,Ws", [(13, 21), (89, 121)])
@pytest.mark.parametrize("C", [1, 3, 5])
def test_bilinear_warp_plane_list_matches_stacked(C, Hs, Ws):
    """The list entry (planes read in place, at strides 1, 2 and 3) equals
    ``bilinear_warp_planes`` of the stacked planes bit for bit, NaN in the
    same places, at coordinates off every side and not finite."""
    planes = _plane_list(C, Hs, Ws, seed=C)
    x1, y1 = (T(a) for a in _coords_all_sides(Hs, Ws, seed=10 + C))
    out = tdw.bilinear_warp_plane_list(planes, x1, y1).numpy()
    ref = tdw.bilinear_warp_planes(torch.stack(planes), x1, y1).numpy()
    assert out.shape == (C, Hs, Ws)
    np.testing.assert_array_equal(out, ref)
    assert np.isfinite(out[:, 1:]).all()


@pytest.mark.parametrize("Hs,Ws", [(13, 21), (89, 121)])
@pytest.mark.parametrize("C", [1, 3, 5])
def test_bilinear_warp_plane_list_matches_jax(C, Hs, Ws):
    """Against the JAX package's XLA reference, at coordinates off all four
    sides."""
    planes = _plane_list(C, Hs, Ws, seed=20 + C)
    x1, y1 = _coords_all_sides(Hs, Ws, seed=30 + C, special=False)
    out = tdw.bilinear_warp_plane_list(planes, T(x1), T(y1)).numpy()
    ref, _ = jwk.bilinear_warp_reference(
        jnp.asarray(np.stack([p.numpy() for p in planes])), jnp.asarray(x1),
        jnp.asarray(y1))
    np.testing.assert_allclose(out, np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("C", [1, 3, 5])
def test_bilinear_warp_plane_list_matches_pallas_at_special_coords(C):
    """Against the JAX package's Pallas kernel in interpret mode (the XLA
    reference gives NaN at +inf, where the kernel clamps), at coordinates
    off all four sides and at +-inf, NaN and +-3e38, at a size that
    satisfies the Pallas tile rule, where the kernel's band covers the
    pixel (all but y = +inf and +3e38 of the special ones): NaN in the same
    places, every other value to ATOL."""
    planes = _plane_list(C, H, W, seed=40 + C)
    x1, y1 = _coords_all_sides(H, W, seed=50 + C)
    out = tdw.bilinear_warp_plane_list(planes, T(x1), T(y1)).numpy()
    ref, cover = jwk.bilinear_warp_planes(
        jnp.asarray(np.stack([p.numpy() for p in planes])), jnp.asarray(x1),
        jnp.asarray(y1), band=H, interpret=True)
    c = np.asarray(cover) > 0.5
    assert c.mean() > 0.9
    ref = np.asarray(ref)[:, c]
    out = out[:, c]
    nan = np.isnan(ref)
    assert nan.any() and not nan.all()
    np.testing.assert_array_equal(np.isnan(out), nan)
    np.testing.assert_allclose(out[~nan], ref[~nan], atol=ATOL)


@pytest.mark.parametrize("case,stride", [("contiguous", 1), ("channel0", 2),
                                         ("channel1", 2), ("of_three", 3),
                                         ("transposed", None),
                                         ("column", None), ("float64", None),
                                         ("shape", None)])
def test_plane_stride_accepts_rows_at_a_constant_stride(case, stride):
    """What the CUDA path hands the kernel for each plane: its element
    stride where the plane's pixels lie at one stride in row-major order,
    an error for anything else."""
    Hs, Ws = 6, 10
    grad = torch.zeros(Hs, Ws, 2)
    t = {"contiguous": torch.zeros(Hs, Ws), "channel0": grad[..., 0],
         "channel1": grad[..., 1], "of_three": torch.zeros(Hs, Ws, 3)[..., 2],
         "transposed": torch.zeros(Ws, Hs).T,
         "column": torch.zeros(Hs, Ws + 1)[:, 1:],
         "float64": torch.zeros(Hs, Ws, dtype=torch.float64),
         "shape": torch.zeros(Hs + 1, Ws)}[case]
    if stride is None:
        with pytest.raises((ValueError, TypeError)):
            tdw._plane_stride(t, case, Hs, Ws, t.device)
    else:
        assert tdw._plane_stride(t, case, Hs, Ws, t.device) == stride


def _warp_problem(P, seed):
    pr = make_problem(H, W, 4, 3, P, seed=seed)
    src, dst = pr["src"], pr["dst"]
    cj, ct = cams(H, W)
    pj = jax.vmap(jse3.relative_pose)(
        JSE3(jnp.asarray(pr["q"][dst]), jnp.asarray(pr["t"][dst])),
        JSE3(jnp.asarray(pr["q"][src]), jnp.asarray(pr["t"][src])))
    pt = tse3.relative_pose(TSE3(T(pr["q"][dst]), T(pr["t"][dst])),
                            TSE3(T(pr["q"][src]), T(pr["t"][src])))
    planes = (pr["dpt"][src], pr["imgs"][dst],
              np.ascontiguousarray(pr["grads"][dst][..., 0]),
              np.ascontiguousarray(pr["grads"][dst][..., 1]))
    return pr, cj, ct, pj, pt, planes


def _near_border(x1, y1, border, eps=1e-4):
    d = np.minimum.reduce([np.abs(x1 - border), np.abs(x1 - (W - border)),
                           np.abs(y1 - border), np.abs(y1 - (H - border))])
    return d < eps


@pytest.mark.parametrize("border,min_dpt", [(1, 0.0), (2, 0.01), (6, 0.0)])
def test_dense_warp_batch_plain_matches_pallas_interpret(border, min_dpt):
    P = 3
    _, cj, ct, pj, pt, planes = _warp_problem(P, seed=4)
    kj = jwk.make_warp_params(pj, cj, border, min_dpt)
    kt = tdw.make_warp_params(pt, ct, border, min_dpt)
    assert kt.shape == (P, 24)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=1e-6)
    ref = [np.asarray(a) for a in jwk.dense_warp_batch(
        kj, *(jnp.asarray(a) for a in planes), band=16, interpret=True)]
    out = [a.numpy() for a in tdw.dense_warp_batch(kt, *(T(a) for a in planes))]
    assert all(a.shape == (P, H, W) for a in out)
    for k in (3, 4, 5):                                   # tptx, tpty, tptz
        np.testing.assert_allclose(out[k], ref[k], atol=ATOL)
    # the TPU kernel's valid also folds its band coverage: where it says
    # valid the port must agree, and the samples are held there
    both = ref[6] > 0.5
    assert both.mean() > 0.5
    x1 = 60.0 * out[3] / out[5] + W / 2
    y1 = 60.0 * out[4] / out[5] + H / 2
    off = both & (out[6] < 0.5)
    assert not (off & ~_near_border(x1, y1, border)).any()
    for k in (0, 1, 2):                                   # i1, gx, gy
        assert np.abs(out[k] - ref[k])[both].max() < ATOL
    assert set(np.unique(out[6])) <= {0.0, 1.0}


@pytest.mark.parametrize("border,min_dpt", [(1, 0.0), (5, 0.0), (1, 2.0)])
def test_dense_warp_batch_plain_matches_xla_fields(xla_warp, border, min_dpt):
    """Against ``_dense_warp_fields`` + ``bilinear_sample`` per factor,
    which has no band: ``valid`` is held everywhere. A wider border and a
    min_dpt inside the depth range both drop pixels."""
    P = 3
    pr, cj, ct, pj, pt, planes = _warp_problem(P, seed=9)
    kt = tdw.make_warp_params(pt, ct, border, min_dpt)
    out = [a.numpy() for a in tdw.dense_warp_batch(kt, *(T(a) for a in planes))]
    n_valid = 0
    for p in range(P):
        f = jds._dense_warp_fields(H, W, jnp.asarray(planes[0][p]).reshape(-1),
                                   cj, jse3.index(pj, p), border, min_dpt)
        pix = jnp.stack([f.pix1x, f.pix1y], axis=-1)
        x1, y1 = (np.asarray(a).reshape(H, W) for a in (f.pix1x, f.pix1y))
        v = np.asarray(f.valid).reshape(H, W)
        diff = v != (out[6][p] > 0.5)
        assert not (diff & ~_near_border(x1, y1, border)).any()
        n_valid += v.sum()
        for k, a in zip((3, 4, 5), (f.tptx, f.tpty, f.tptz)):
            np.testing.assert_allclose(out[k][p].reshape(-1), np.asarray(a),
                                       atol=ATOL)
        for k in range(3):
            s = bilinear_sample(jnp.asarray(planes[1 + k][p]), pix)
            np.testing.assert_allclose(out[k][p].reshape(-1), np.asarray(s),
                                       atol=ATOL)
    full = tdw.dense_warp_batch(tdw.make_warp_params(pt, ct, 1, 0.0),
                                *(T(a) for a in planes))[6].sum()
    assert 0 < n_valid and (n_valid < full if (border, min_dpt) != (1, 0.0)
                            else n_valid == full)


def _step_args(pr, P):
    src, dst = pr["src"], pr["dst"]
    return (pr["codes"][src], pr["imgs"][src], pr["imgs"][dst], pr["dpt"][src],
            np.zeros((P,) + pr["imgs"].shape[1:], np.float32), pr["jac"][src],
            pr["grads"][dst])


def _check_system(out, ref):
    JtJ, Jtr, res, inl = (np.asarray(x) for x in out)
    np.testing.assert_array_equal(inl, np.asarray(ref.inliers))
    assert np.all(inl > 0)
    assert rel_err(JtJ, np.asarray(ref.JtJ)) < TOL
    assert rel_err(Jtr, np.asarray(ref.Jtr)) < TOL
    np.testing.assert_allclose(res, np.asarray(ref.residual), rtol=1e-4)


@pytest.mark.parametrize("loss", ["huber", "tukey"])
def test_sfm_step_sampled_matches_jax(xla_warp, loss):
    Hs, Ws, CS = 48, 64, 8
    pr = make_problem(Hs, Ws, CS, 3, 2, seed=6)
    cj, ct = cams(Hs, Ws)
    a = [x[0] for x in _step_args(pr, 2)]
    s, d = pr["src"][0], pr["dst"][0]
    kwj = dict(huber_delta=0.1, avg_dpt=2.0, min_dpt=0.01, valid_border=2)
    ref, vj = jds.sfm_step(
        JSE3(jnp.asarray(pr["q"][s]), jnp.asarray(pr["t"][s])),
        JSE3(jnp.asarray(pr["q"][d]), jnp.asarray(pr["t"][d])),
        jnp.asarray(a[0]), cj, *(jnp.asarray(x) for x in a[1:]),
        jds.SfmParams(**kwj), grad_mode="sampled", loss=loss)
    out, vt = tds.sfm_step(
        TSE3(T(pr["q"][s]), T(pr["t"][s])), TSE3(T(pr["q"][d]), T(pr["t"][d])),
        T(a[0]), ct, *(T(np.ascontiguousarray(x)) for x in a[1:]),
        tds.SfmParams(**kwj), grad_mode="sampled", loss=loss)
    _check_system(out, ref)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(out.JtJ.numpy(), out.JtJ.numpy().T)


@pytest.mark.parametrize("chunk_bytes", [1 << 30, 1])
def test_sfm_step_batch_sampled_matches_jax(xla_warp, monkeypatch, chunk_bytes):
    """The batched branch (one dense_warp_batch call, Jacobians and JtJ
    batched over the factor axis) against JAX's vmapped ``sfm_step``; with
    a chunk budget of one byte every factor is its own chunk."""
    Hs, Ws, CS, P = 48, 64, 8, 4
    monkeypatch.setattr(tds, "_JT_CHUNK_BYTES", chunk_bytes)
    pr = make_problem(Hs, Ws, CS, 4, P, seed=8)
    cj, ct = cams(Hs, Ws)
    src, dst = pr["src"], pr["dst"]
    args = _step_args(pr, P)
    kw = dict(huber_delta=0.1, avg_dpt=2.0, min_dpt=0.01, valid_border=2)
    ref = jds.sfm_step_batch(
        JSE3(jnp.asarray(pr["q"][src]), jnp.asarray(pr["t"][src])),
        JSE3(jnp.asarray(pr["q"][dst]), jnp.asarray(pr["t"][dst])),
        jnp.asarray(args[0]), cj, *(jnp.asarray(a) for a in args[1:]),
        jds.SfmParams(**kw), grad_mode="sampled")
    out = tds.sfm_step_batch(
        TSE3(T(pr["q"][src]), T(pr["t"][src])),
        TSE3(T(pr["q"][dst]), T(pr["t"][dst])),
        T(args[0]), ct, *(T(np.ascontiguousarray(a)) for a in args[1:]),
        tds.SfmParams(**kw), grad_mode="sampled")
    assert out.JtJ.shape == (P, 12 + CS, 12 + CS) and out.Jtr.shape == (P, 12 + CS)
    _check_system(out, ref)


def _depth_problem(K, CS, Hs, Ws, seed):
    rng = np.random.RandomState(seed)
    return dict(
        code=(0.1 * rng.standard_normal((K, CS))).astype(np.float32),
        tgt=(1.5 + rng.rand(K, Hs, Ws)).astype(np.float32),
        prx0=(0.45 + 0.1 * rng.rand(K, Hs, Ws)).astype(np.float32),
        jac=(0.02 * rng.standard_normal((K, Hs, Ws, CS))).astype(np.float32))


def _close(a, b, tol=1e-5):
    b = np.asarray(b)
    np.testing.assert_allclose(np.asarray(a), b, rtol=tol,
                               atol=tol * np.abs(b).max())


def test_depth_align_steps_match_jax():
    CS = 6
    d = _depth_problem(1, CS, 24, 32, seed=3)
    code, tgt, prx0, jac = (d[k][0] for k in ("code", "tgt", "prx0", "jac"))
    jacT = np.ascontiguousarray(jac.transpose(2, 0, 1))
    ref = jds.depth_align_step(jnp.asarray(code), jnp.asarray(tgt),
                               jnp.asarray(prx0), jnp.asarray(jac), 2.0)
    out = tds.depth_align_step(T(code), T(tgt), T(prx0), T(jac), 2.0)
    refT = jds.depth_align_step_T(jnp.asarray(code), jnp.asarray(tgt),
                                  jnp.asarray(prx0), jnp.asarray(jacT), 2.0)
    outT = tds.depth_align_step_T(T(code), T(tgt), T(prx0), T(jacT), 2.0)
    for o, r in ((out, ref), (outT, refT)):
        assert o.JtJ.shape == (CS, CS) and float(o.inliers) == 24 * 32
        for a, b in zip(o, r):
            _close(a, b)
    assert rel_err(out.JtJ.numpy(), outT.JtJ.numpy()) > 1e-2   # they differ


def test_depth_prior_batch_matches_jax():
    K, CS, Hs, Ws, L = 3, 4, 24, 32, 2
    js = jms.create(K, CS, Hs, Ws, L, max_links=4)
    ts = tms.create(K, CS, Hs, Ws, L, max_links=4, device="cpu")
    lv = [_depth_problem(K, CS, Hs >> l, Ws >> l, seed=20 + l) for l in range(L)]
    jl, tl = [], []
    for l in range(L):
        jacT = np.ascontiguousarray(lv[l]["jac"].transpose(0, 3, 1, 2))
        jl.append(js.levels[l]._replace(prx0=jnp.asarray(lv[l]["prx0"]),
                                        jac=jnp.asarray(jacT)))
        tl.append(ts.levels[l]._replace(prx0=T(lv[l]["prx0"]), jac=T(jacT)))
    js = js._replace(code=jnp.asarray(lv[0]["code"]), levels=tuple(jl))
    ts = ts._replace(code=T(lv[0]["code"]), levels=tuple(tl))
    ref = jfct.depth_prior_batch(js, tuple(jnp.asarray(x["tgt"]) for x in lv),
                                 0.5, 2.0)
    out = tfct.depth_prior_batch(ts, tuple(T(x["tgt"]) for x in lv), 0.5, 2.0)
    assert out.JtJ.shape == (K, CS, CS) and out.Jtr.shape == (K, CS)
    for a, b in zip(out, ref):
        _close(a, b)


def test_cpu_tensors_never_launch_the_warp_kernels():
    assert tdw.LAUNCHES == {"dense_warp_batch": 0, "bilinear_warp_planes": 0}
    assert jax.devices()[0].platform == "cpu"
