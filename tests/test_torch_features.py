"""features/ (detector, matching, 8-point RANSAC) of deepfactors_tpu_torch
against the JAX package's, on inputs made from a numpy seed or rendered by
the JAX package's synthetic room.

Tolerances:
  - ``harris_response``: within 1e-5 of max|R| (the same filter taps in the
    same order on both sides; found identical);
  - ``_nms``: identical;
  - ``detect`` / ``detect_pyramid`` at 48x64 and 96x128: validity and the
    valid keypoints' xy identical (the top-K order is a stable sort, the
    lower index first among ties, as ``lax.top_k``), angles within 1e-4
    rad (atan2 of moment sums taken in another order), descriptors within
    1 bit per keypoint and 2 bits over the set: bit ``v1 < v2`` compares
    two bilinear samples, and it flips only where the two samples agree to
    within fp32 rounding of the rotated pattern (found: 0 bits);
  - ``popcount32``, ``hamming_matrix``, ``match``: exact (integer
    arithmetic; on the JAX package's own descriptors);
  - ``prune_matches_eight_point`` with the JAX draws passed as ``idx``:
    the inlier mask identical, except for a match whose epipolar error lies
    within 1e-3 (relative) of the threshold, in the cases clean, 30%
    outliers and none valid. The draws are made with replacement, so a
    hypothesis may repeat a match; its system then has rank below 8 and
    the null vector that LAPACK returns is arbitrary (the two packages'
    SVDs pick different ones). In the clean and outlier cases the winning
    hypothesis is well conditioned. With fewer than 8 valid matches every
    hypothesis is rank deficient, so the masks need not agree; that case
    holds what the mapper reads of it: no invalid match marked, and fewer
    than 8 inliers in both packages, so the 8-match guard drops the
    direction in both."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfactors_tpu.features import detector as jdet
from deepfactors_tpu.features import matching as jmt
from deepfactors_tpu.geometry import se3 as jse3
from deepfactors_tpu.geometry.camera import PinholeCamera as JCam
from deepfactors_tpu.io import synth as jsynth
from deepfactors_tpu.ops import image as jip
from deepfactors_tpu_torch.features import detector as tdet
from deepfactors_tpu_torch.features import matching as tmt
from deepfactors_tpu_torch.geometry.camera import PinholeCamera as TCam
from deepfactors_tpu_torch.ops import image as tip

torch.set_num_threads(2)
SIZES = [(48, 64), (96, 128)]


def _frames(H, W, idx=(0, 4)):
    kw = dict(fx=55.0 * W / 64, fy=55.0 * W / 64, u0=W / 2, v0=H / 2,
              width=W, height=H)
    scene = jsynth.random_room(7, n_boxes=3)
    poses = jsynth.orbit_trajectory(80, sweep=3.2 * np.pi)[:max(idx) + 1]
    frames = jsynth.render_sequence(scene, JCam.create(**kw), poses, H, W)
    return [np.array(frames[i]) for i in idx]


def _same_features(a, b, angle_tol=1e-4):
    """a: the port's Features, b: the JAX package's."""
    va, vb = a.valid.numpy(), np.asarray(b.valid)
    np.testing.assert_array_equal(va, vb)
    np.testing.assert_array_equal(a.xy.numpy()[vb], np.asarray(b.xy)[vb])
    np.testing.assert_allclose(a.angle.numpy()[vb], np.asarray(b.angle)[vb],
                               atol=angle_tol)
    x = np.bitwise_xor(a.descriptor.numpy().view(np.uint32)[vb],
                       np.asarray(b.descriptor)[vb])
    bits = np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)
    assert bits.max(initial=0) <= 1 and bits.sum() <= 2, bits


@pytest.mark.parametrize("H,W", SIZES)
def test_harris_and_nms_match_jax(H, W):
    img = _frames(H, W)[0]
    a = tdet.harris_response(torch.from_numpy(img))
    b = np.asarray(jdet.harris_response(jnp.asarray(img)))
    np.testing.assert_allclose(a.numpy(), b, atol=1e-5 * np.abs(b).max(),
                               rtol=0)
    # on identical scores (the JAX ones), with the -inf border of detect
    s = b.copy()
    s[:4], s[:, -4:] = -np.inf, -np.inf
    np.testing.assert_array_equal(tdet._nms(torch.from_numpy(s), 2).numpy(),
                                  np.asarray(jdet._nms(jnp.asarray(s), 2)))


@pytest.mark.parametrize("H,W", SIZES)
def test_detect_matches_jax(H, W):
    img = _frames(H, W)[1]   # frame 4: frame 0 holds no corner at 96x128
    cfg = dict(max_keypoints=128, border=8)
    a = tdet.detect(torch.from_numpy(img), tdet.DetectorConfig(**cfg))
    b = jdet.detect(jnp.asarray(img), jdet.DetectorConfig(**cfg))
    assert int(a.valid.sum()) >= 5
    _same_features(a, b)


@pytest.mark.parametrize("H,W", SIZES)
def test_detect_pyramid_matches_jax(H, W):
    for img in _frames(H, W):
        a = tdet.detect_pyramid(tip.build_pyramid(torch.from_numpy(img), 3),
                                tdet.DetectorConfig(max_keypoints=128))
        b = jdet.detect_pyramid(
            [jnp.asarray(x) for x in jip.build_pyramid(jnp.asarray(img), 3)],
            jdet.DetectorConfig(max_keypoints=128))
        assert int(a.valid.sum()) >= 8
        _same_features(a, b)


def test_select_uniform_ties_resolve_like_top_k():
    """Scores that tie after the 1e6 cell boost (fp32 spacing there is
    0.0625) keep the lower index first, as lax.top_k does."""
    rng = np.random.RandomState(1)
    n = 60
    xy = rng.randint(0, 64, (n, 2)).astype(np.float32)
    score = rng.choice([1e-3, 2e-3, 5e-3], n).astype(np.float32)
    valid = rng.rand(n) > 0.2
    ia, va = tdet._select_uniform(torch.from_numpy(xy), torch.from_numpy(score),
                                  torch.from_numpy(valid), 64, 48, 10, 32)
    ib, vb = jdet._select_uniform(jnp.asarray(xy), jnp.asarray(score),
                                  jnp.asarray(valid), 64, 48, 10, 32)
    np.testing.assert_array_equal(ia.numpy(), np.asarray(ib))
    np.testing.assert_array_equal(va.numpy(), np.asarray(vb))


def test_popcount_and_hamming_exact():
    rng = np.random.RandomState(0)
    words = rng.randint(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    words[:4] = [0, 0xFFFFFFFF, 0x80000000, 0x80000001]
    a = tmt.popcount32(torch.from_numpy(words.view(np.int32))).numpy()
    b = np.asarray(jmt.popcount32(jnp.asarray(words)))
    np.testing.assert_array_equal(a, b)
    assert list(a[:4]) == [0, 32, 1, 2]
    d0 = rng.randint(0, 2 ** 32, (40, 8), dtype=np.uint64).astype(np.uint32)
    d1 = rng.randint(0, 2 ** 32, (50, 8), dtype=np.uint64).astype(np.uint32)
    d1[:5] = d0[:5] ^ np.uint32(1 << 31)        # top bit differs: distance 8
    a = tmt.hamming_matrix(torch.from_numpy(d0.view(np.int32)),
                           torch.from_numpy(d1.view(np.int32))).numpy()
    b = np.asarray(jmt.hamming_matrix(jnp.asarray(d0), jnp.asarray(d1)))
    np.testing.assert_array_equal(a, b)
    assert (np.diag(a[:5, :5]) == 8).all()


def test_match_exact_on_jax_descriptors():
    f = []
    for img in _frames(96, 128, (0, 2)):
        pyr = [jnp.asarray(x) for x in jip.build_pyramid(jnp.asarray(img), 3)]
        f.append(jdet.detect_pyramid(pyr, jdet.DetectorConfig(max_keypoints=128)))
    rng = np.random.RandomState(2)
    # add near duplicates so that ties in distance occur
    d1 = np.array(f[1].descriptor)
    d1[40:60] = np.array(f[0].descriptor)[:20] ^ np.uint32(1 << 31)
    d1[60:80] = np.array(f[0].descriptor)[:20] ^ np.uint32(1)
    v0 = np.array(f[0].valid) | (rng.rand(128) > 0.5)
    v1 = np.array(f[1].valid) | (rng.rand(128) > 0.5)
    b = jmt.match(f[0].descriptor, jnp.asarray(v0), jnp.asarray(d1),
                  jnp.asarray(v1), max_dist=30)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    a = tmt.match(t(np.array(f[0].descriptor).view(np.int32)), t(v0),
                  t(d1.view(np.int32)), t(v1), max_dist=30)
    for n in tmt.Matches._fields:
        np.testing.assert_array_equal(getattr(a, n).numpy(),
                                      np.asarray(getattr(b, n)))
    assert np.asarray(b.valid).sum() >= 20


def _ransac_case(kind, seed=0, M=128):
    """Matches of a general two-view motion: pixel pairs of random points
    at 2-6 m under a rotation of ~5 deg and a 0.3 m baseline."""
    rng = np.random.RandomState(seed)
    H, W = 192, 256
    kw = dict(fx=220.0, fy=220.0, u0=W / 2, v0=H / 2, width=W, height=H)
    xy0 = np.stack([rng.uniform(20, W - 20, M), rng.uniform(20, H - 20, M)], -1)
    z = rng.uniform(2.0, 6.0, M)
    pts = np.stack([(xy0[:, 0] - W / 2) / 220.0 * z,
                    (xy0[:, 1] - H / 2) / 220.0 * z, z], -1)
    pose = jse3.retract(jse3.identity(), jnp.asarray(
        [0.3, -0.05, 0.08, 0.02, 0.08, -0.03], jnp.float32))
    p1 = np.asarray(jse3.act(pose, jnp.asarray(pts, jnp.float32)))
    xy1 = np.stack([220.0 * p1[:, 0] / p1[:, 2] + W / 2,
                    220.0 * p1[:, 1] / p1[:, 2] + H / 2], -1)
    xy1 = xy1 + rng.normal(0, 0.1, xy1.shape)
    valid = np.ones(M, bool)
    if kind == "outliers":
        out = rng.rand(M) < 0.3
        xy1[out] = np.stack([rng.uniform(0, W, out.sum()),
                             rng.uniform(0, H, out.sum())], -1)
    elif kind == "few":
        valid[:] = False
        valid[rng.choice(M, 5, replace=False)] = True
    elif kind == "none":
        valid[:] = False
    return (kw, xy0.astype(np.float32), xy1.astype(np.float32), valid)


@pytest.mark.parametrize("kind", ["clean", "outliers", "few", "none"])
def test_prune_eight_point_matches_jax_with_its_draws(kind):
    kw, xy0, xy1, valid = _ransac_case(kind)
    I, thr = 64, 1e-4
    key = jax.random.PRNGKey(5)
    b = np.asarray(jmt.prune_matches_eight_point(
        jnp.asarray(xy0), jnp.asarray(xy1), jnp.asarray(valid),
        JCam.create(**kw), key, threshold=thr, max_iterations=I))
    idx = np.asarray(jax.random.categorical(
        key, jnp.where(jnp.asarray(valid), 0.0, -1e9), shape=(I, 8)))
    t = lambda x: torch.from_numpy(np.array(x))
    cam = TCam.create(**kw)
    a = tmt.prune_matches_eight_point(t(xy0), t(xy1), t(valid), cam,
                                      idx=t(idx), threshold=thr).numpy()
    assert not (a & ~valid).any() and not (b & ~valid).any()
    if kind == "none":
        assert not a.any() and not b.any()
        return
    if kind == "few":
        assert a.sum() < 8 and b.sum() < 8
        return
    # the port's winning hypothesis and its errors, to excuse only matches
    # that sit on the threshold
    b0 = tmt.bearing_vectors(cam, t(xy0))
    b1 = tmt.bearing_vectors(cam, t(xy1))
    Es = tmt._essential_from_8(b0[t(idx)], b1[t(idx)])
    errs = tmt._epipolar_error(Es, b0, b1)
    best = int(torch.argmax(torch.sum((errs < thr) & t(valid), -1)))
    near = np.abs(errs[best].numpy() - thr) <= 1e-3 * thr
    np.testing.assert_array_equal(a[~near], b[~near])
    if kind == "clean":
        assert a.sum() >= 0.9 * len(a)
    if kind == "outliers":
        assert a.sum() >= 0.6 * len(a)


def test_draw_hypotheses_uniform_over_valid_or_all():
    g = torch.Generator().manual_seed(42)
    valid = torch.zeros((3, 50), dtype=torch.bool)
    valid[0, [3, 7, 11]] = True
    valid[1] = True
    idx = tmt.draw_hypotheses(valid, 200, g)
    assert idx.shape == (3, 200, 8)
    assert set(idx[0].unique().tolist()) == {3, 7, 11}
    assert len(idx[1].unique()) == 50 and len(idx[2].unique()) == 50
