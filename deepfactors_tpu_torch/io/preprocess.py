"""Frame preprocessing: undistort + remap to the network's trained camera,
resize, grayscale.

PyTorch port's copy of ``deepfactors_tpu/io/preprocess.py`` (the
reference's PreprocessImage, deepfactors.cpp:634-680): a map from the
source camera to the network's trained intrinsics and resolution is built
once and every frame is sampled through it. Host-side numpy on purpose, as
in the JAX package: it sits on the camera I/O path in front of the device
pipeline, and a device remap would add a read-back to every pipelined
dispatch.

Distortion model: OpenCV plumb_bob (k1, k2, p1, p2, k3). The map is built
output -> input: each network pixel is lifted through K_net^-1, distorted,
and projected through K_src (initUndistortRectifyMap with R = I and
newCameraMatrix = K_net).

The JAX package samples with ``cv2.remap`` / ``cv2.resize`` (INTER_LINEAR,
float32). The port needs no OpenCV and reproduces OpenCV 5.0's arithmetic
for float32 images bit for bit: the tap fraction is kept whole (no 1/32
quantisation) and each interpolation is a fused multiply-add,
``fma(f, b - a, a)``, first along x (both rows), then along y; ``resize``
takes the source coordinate ``(d + 0.5) * (n_in / n_out) - 0.5`` in double
precision, a fraction rounded to float32 and a clamp to the border pixel
(weight 0). The fma is emulated in float64 and rounded once to float32.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np

_F32 = np.float32


class SourceCamera(NamedTuple):
    fx: float
    fy: float
    u0: float
    v0: float
    width: int
    height: int
    dist: Optional[Sequence[float]] = None  # (k1, k2, p1, p2[, k3])


def build_remap(src: SourceCamera, fx: float, fy: float, u0: float,
                v0: float, width: int, height: int):
    """Precompute the (map_x, map_y) float32 sampling grid from the trained
    camera (fx, fy, u0, v0, width, height) back into source pixels."""
    xs, ys = np.meshgrid(np.arange(width, dtype=np.float64),
                         np.arange(height, dtype=np.float64))
    x = (xs - u0) / fx
    y = (ys - v0) / fy
    if src.dist is not None and np.any(np.asarray(src.dist) != 0):
        d = list(src.dist) + [0.0] * (5 - len(src.dist))
        k1, k2, p1, p2, k3 = d[:5]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x, y = xd, yd
    map_x = (src.fx * x + src.u0).astype(_F32)
    map_y = (src.fy * y + src.v0).astype(_F32)
    return map_x, map_y


def _fma(a, b, c) -> np.ndarray:
    """float32 a * b + c with one rounding (a * b of two float32 values is
    exact in float64)."""
    return (np.asarray(a, np.float64) * b + np.asarray(c, np.float64)
            ).astype(_F32)


def _bilinear(img, y0, y1, x0, x1, fy, fx) -> np.ndarray:
    """OpenCV 5.0's bilinear step: x first on both rows, then y."""
    img = np.asarray(img, _F32)
    p00, p01 = img[y0, x0], img[y0, x1]
    p10, p11 = img[y1, x0], img[y1, x1]
    top = _fma(fx, p01 - p00, p00)
    bot = _fma(fx, p11 - p10, p10)
    return _fma(fy, bot - top, top)


def remap_bilinear(img: np.ndarray, map_x: np.ndarray,
                   map_y: np.ndarray) -> np.ndarray:
    """Sample ``img`` at (map_y, map_x) with bilinear interpolation and a
    border clamp (``cv2.remap`` INTER_LINEAR, BORDER_REPLICATE, float32)."""
    H, W = img.shape[:2]
    map_x = np.asarray(map_x, _F32)
    map_y = np.asarray(map_y, _F32)
    fx0, fy0 = np.floor(map_x), np.floor(map_y)
    fx, fy = map_x - fx0, map_y - fy0      # exact in float32
    x0, y0 = fx0.astype(np.int64), fy0.astype(np.int64)
    if img.ndim == 3:
        fx, fy = fx[..., None], fy[..., None]
    return _bilinear(img, np.clip(y0, 0, H - 1), np.clip(y0 + 1, 0, H - 1),
                     np.clip(x0, 0, W - 1), np.clip(x0 + 1, 0, W - 1), fy, fx)


def _resize_taps(n_out: int, n_in: int):
    f = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    s = np.floor(f)
    frac = (f - s).astype(_F32)
    s = s.astype(np.int64)
    low, high = s < 0, s >= n_in - 1
    frac[low | high] = 0.0
    s = np.clip(s, 0, n_in - 1)
    return s, np.minimum(s + 1, n_in - 1), frac


def resize_bilinear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(img, (width, height), interpolation=INTER_LINEAR)`` for
    a float32 image: half-pixel centres, clamped at the border."""
    sx, sx1, fx = _resize_taps(width, img.shape[1])
    sy, sy1, fy = _resize_taps(height, img.shape[0])
    fx, fy = fx[None, :], fy[:, None]
    if img.ndim == 3:
        fx, fy = fx[..., None], fy[..., None]
    return _bilinear(img, sy[:, None], sy1[:, None], sx[None, :],
                     sx1[None, :], fy, fx)


def to_gray_float(img) -> np.ndarray:
    """BGR/RGB uint8 or float image -> grayscale float32 in [0, 1]
    (deepfactors.cpp:648-655)."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        img = img.astype(_F32) / 255.0
    if img.ndim == 3:
        img = img @ np.asarray([0.114, 0.587, 0.299], _F32)  # BGR
    return img.astype(_F32)
