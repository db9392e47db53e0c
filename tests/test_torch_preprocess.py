"""Frame preprocessing of deepfactors_tpu_torch (io/preprocess.py and the
facade's set_source_camera / preprocess_image) against the JAX package and
OpenCV, on the same numpy inputs from a seed.

Tolerances:
  - build_remap: the same float64 arithmetic as the JAX package, identical
    float32 maps;
  - remap_bilinear and resize_bilinear against cv2.remap / cv2.resize
    (INTER_LINEAR, float32; the JAX package's path where cv2 imports):
    bit for bit. OpenCV 5.0, which these tests run against, keeps the tap
    fraction whole and interpolates with a fused multiply-add, x then y;
    the port emulates the fma in float64;
  - remap_bilinear against the JAX package's numpy fallback (cv2 not
    importable): the fallback rounds each product separately, within 3e-7
    on [0, 1] images;
  - to_gray_float and the facade's preprocess_image: identical with
    intrinsics that float32 holds exactly. The JAX package's camera holds
    its intrinsics as float32, the port's as Python floats, so a trained
    camera such as (52.0, 51.5, 31.9, 25.4) gives maps that differ by the
    float32 rounding of 31.9 and 25.4: remapped frames within 2e-5.
"""
import sys

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from deepfactors_tpu.io import preprocess as jpp  # noqa: E402
from deepfactors_tpu_torch.io import preprocess as pp  # noqa: E402

torch.set_num_threads(2)

DIST = (-0.21, 0.05, 0.001, -0.002, 0.01)
TUM = pp.SourceCamera(517.3, 516.5, 318.6, 255.3, 640, 480, DIST)


def test_identity_remap():
    src = pp.SourceCamera(60.0, 60.0, 32.0, 24.0, 64, 48)
    mx, my = pp.build_remap(src, 60.0, 60.0, 32.0, 24.0, 64, 48)
    xs, ys = np.meshgrid(np.arange(64, dtype=np.float32),
                         np.arange(48, dtype=np.float32))
    np.testing.assert_allclose(mx, xs, atol=1e-5)
    np.testing.assert_allclose(my, ys, atol=1e-5)
    img = np.random.RandomState(0).rand(48, 64).astype(np.float32)
    np.testing.assert_allclose(pp.remap_bilinear(img, mx, my), img, atol=1e-6)


def test_principal_point_shift_translates():
    src = pp.SourceCamera(60.0, 60.0, 34.0, 24.0, 64, 48)
    mx, _ = pp.build_remap(src, 60.0, 60.0, 32.0, 24.0, 64, 48)
    xs, _ = np.meshgrid(np.arange(64, dtype=np.float32),
                        np.arange(48, dtype=np.float32))
    np.testing.assert_allclose(mx, xs + 2.0, atol=1e-5)


def test_focal_scale_matches_resize_model():
    src = pp.SourceCamera(120.0, 120.0, 64.0, 48.0, 128, 96)
    mx, my = pp.build_remap(src, 60.0, 60.0, 32.0, 24.0, 64, 48)
    np.testing.assert_allclose(mx[0, 10], 20.0, atol=1e-5)
    np.testing.assert_allclose(my[10, 0], 20.0, atol=1e-5)


def test_radial_distortion_moves_corners_outward():
    src = pp.SourceCamera(60.0, 60.0, 32.0, 24.0, 64, 48,
                          dist=(-0.2, 0.0, 0.0, 0.0))
    mx, my = pp.build_remap(src, 60.0, 60.0, 32.0, 24.0, 64, 48)
    np.testing.assert_allclose(mx[24, 32], 32.0, atol=1e-3)
    assert mx[0, 0] > 0.0 and my[0, 0] > 0.0


@pytest.mark.parametrize("dist", [None, (-0.2, 0.0, 0.0, 0.0), DIST])
def test_build_remap_matches_jax(dist):
    args = (206.92, 206.6, 127.44, 102.12, 256, 192)
    t = pp.build_remap(TUM._replace(dist=dist), *args)
    j = jpp.build_remap(jpp.SourceCamera(*TUM._replace(dist=dist)), *args)
    for a, b in zip(t, j):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def _maps(seed, h, w, H, W):
    """Random sampling maps over the source and 3 px past its border."""
    rng = np.random.RandomState(seed)
    return ((rng.rand(h, w) * (W + 6) - 3).astype(np.float32),
            (rng.rand(h, w) * (H + 6) - 3).astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_remap_matches_cv2_and_jax(seed):
    rng = np.random.RandomState(seed)
    img = rng.rand(48, 64).astype(np.float32)
    mx, my = _maps(seed, 60, 80, 48, 64)
    out = pp.remap_bilinear(img, mx, my)
    ref = cv2.remap(img, mx, my, interpolation=cv2.INTER_LINEAR,
                    borderMode=cv2.BORDER_REPLICATE)
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out, jpp.remap_bilinear(img, mx, my))
    # the real case: distorted 640x480 to 256x192
    big = rng.rand(480, 640).astype(np.float32)
    m = pp.build_remap(TUM, 206.92, 206.6, 127.44, 102.12, 256, 192)
    np.testing.assert_array_equal(pp.remap_bilinear(big, *m),
                                  jpp.remap_bilinear(big, *m))


def test_remap_against_jax_numpy_fallback(monkeypatch):
    rng = np.random.RandomState(3)
    img = rng.rand(48, 64).astype(np.float32)
    mx, my = _maps(3, 60, 80, 48, 64)
    monkeypatch.setitem(sys.modules, "cv2", None)   # import cv2 -> error
    fallback = jpp.remap_bilinear(img, mx, my)
    out = pp.remap_bilinear(img, mx, my)
    assert np.abs(out - fallback).max() <= 3e-7


@pytest.mark.parametrize("src_hw,dst_hw", [((240, 320), (192, 256)),
                                           ((480, 640), (192, 256)),
                                           ((48, 64), (100, 130)),
                                           ((96, 128), (48, 64))])
def test_resize_matches_cv2(src_hw, dst_hw):
    img = np.random.RandomState(sum(src_hw)).rand(*src_hw).astype(np.float32)
    out = pp.resize_bilinear(img, dst_hw[1], dst_hw[0])
    ref = cv2.resize(img, (dst_hw[1], dst_hw[0]),
                     interpolation=cv2.INTER_LINEAR)
    assert out.shape == dst_hw
    np.testing.assert_array_equal(out, ref)


def test_to_gray_float():
    img = np.zeros((4, 4, 3), np.uint8)
    img[..., 2] = 255  # red in BGR
    g = pp.to_gray_float(img)
    assert g.shape == (4, 4) and abs(float(g[0, 0]) - 0.299) < 1e-3
    rng = np.random.RandomState(0)
    for x in (rng.randint(0, 256, (9, 11, 3)).astype(np.uint8),
              rng.randint(0, 256, (9, 11)).astype(np.uint8),
              rng.rand(9, 11, 3).astype(np.float32),
              rng.rand(9, 11)):
        a, b = pp.to_gray_float(x), jpp.to_gray_float(x)
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def _systems(H=48, W=64, u0=31.875, v0=25.375):
    from deepfactors_tpu.geometry.camera import PinholeCamera as JCam
    from deepfactors_tpu.mapping.mapper import MapperConfig as JMC
    from deepfactors_tpu.system import DeepFactors as JDF
    from deepfactors_tpu.system import SystemConfig as JSC
    from deepfactors_tpu_torch.geometry.camera import PinholeCamera
    from deepfactors_tpu_torch.mapping.mapper import MapperConfig
    from deepfactors_tpu_torch.system import DeepFactors, SystemConfig

    kw = dict(max_keyframes=4, max_frames=1, max_factors=8, code_size=4,
              height=H, width=W, pyramid_levels=2, pho_iters=(2, 3),
              use_schur=False, use_reprojection=False)
    cam = dict(fx=52.0, fy=51.5, u0=u0, v0=v0, width=W, height=H)
    t = DeepFactors(SystemConfig(mapper=MapperConfig(**kw),
                                 tracking_iterations=(4, 4),
                                 loop_closure=False),
                    PinholeCamera.create(**cam), decoder=None, device="cpu")
    j = JDF(JSC(mapper=JMC(**kw), tracking_iterations=(4, 4),
                loop_closure=False), JCam.create(**cam), decoder=None)
    return t, j


def test_facade_preprocess_matches_jax():
    """Resize (a frame of another size, no source camera), then remap (a
    distorted source camera), each on a BGR u8 frame: identical."""
    from deepfactors_tpu.io.preprocess import SourceCamera as JSrc

    t, j = _systems()
    rng = np.random.RandomState(5)
    frame = rng.randint(0, 256, (96, 128, 3)).astype(np.uint8)
    a, b = t.preprocess_image(frame), np.asarray(j.preprocess_image(frame))
    assert a.shape == (48, 64) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    # a frame at the configured size passes through
    small = rng.rand(48, 64).astype(np.float32)
    np.testing.assert_array_equal(t.preprocess_image(small), small)
    src = (104.0, 103.0, 63.8, 50.8, 128, 96, DIST)
    t.set_source_camera(pp.SourceCamera(*src))
    j.set_source_camera(JSrc(*src))
    a, b = t.preprocess_image(frame), np.asarray(j.preprocess_image(frame))
    np.testing.assert_array_equal(a, b)
    # a trained camera float32 does not hold exactly
    t, j = _systems(u0=31.9, v0=25.4)
    t.set_source_camera(pp.SourceCamera(*src))
    j.set_source_camera(JSrc(*src))
    a, b = t.preprocess_image(frame), np.asarray(j.preprocess_image(frame))
    assert np.abs(a - b).max() <= 2e-5
