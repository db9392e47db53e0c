"""Image processing ops: bilinear sampling, Sobel gradients, Gaussian
blur-downsample, pyramid construction, depth materialization.

PyTorch port of ``deepfactors_tpu/ops/image.py`` (reference CUDA kernels in
sources/cuda/cu_image_proc.cpp):
  - SobelGradients (cu_image_proc.cpp:57-112): 3x3 Sobel, /8, clamped borders.
  - GaussianBlurDown (cu_image_proc.cpp:134-183): 5x5 binomial blur + 2x
    decimation with clamped taps, /256.
  - UpdateDepth (cu_image_proc.cpp:248-278): dpt = ProxToDepth(prx0 + J·c).

Filters are shift-multiply-adds over the static taps in the same order as
the JAX package, so the two agree to the last bit on the same inputs.

Image layout: [..., H, W] float tensors; pixel coords (x, y), x along W.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..geometry import warping

Tensor = torch.Tensor


# ----------------------------------------------------------------------------
# Bilinear sampling (VisionCore Image2D::getBilinear equivalent)
# ----------------------------------------------------------------------------

def _gather_flat(img: Tensor, idx: Tensor) -> Tensor:
    """img [H, W] with idx [...] -> [...]; img [B, H, W] with idx [B, ...]
    -> [B, ...] (per-batch flat gather)."""
    if img.dim() == 2:
        return img.reshape(-1)[idx]
    B = img.shape[0]
    flat = img.reshape(B, -1)
    return torch.gather(flat, 1, idx.reshape(B, -1)).reshape(idx.shape)


def bilinear_sample(img: Tensor, pix: Tensor) -> Tensor:
    """Sample img [H, W] (or [B, H, W] with pix [B, ..., 2]) at float pixels
    pix (x, y). Floor-based bilinear interpolation like VisionCore's
    getBilinear; out-of-range coords are clamped, callers mask validity."""
    H, W = img.shape[-2], img.shape[-1]
    x = pix[..., 0]
    y = pix[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = x - x0
    wy = y - y0
    x0i = torch.clamp(x0.to(torch.int64), 0, W - 1)
    y0i = torch.clamp(y0.to(torch.int64), 0, H - 1)
    x1i = torch.clamp(x0i + 1, 0, W - 1)
    y1i = torch.clamp(y0i + 1, 0, H - 1)
    v00 = _gather_flat(img, y0i * W + x0i)
    v01 = _gather_flat(img, y0i * W + x1i)
    v10 = _gather_flat(img, y1i * W + x0i)
    v11 = _gather_flat(img, y1i * W + x1i)
    top = v00 * (1 - wx) + v01 * wx
    bot = v10 * (1 - wx) + v11 * wx
    return top * (1 - wy) + bot * wy


def bilinear_sample_grad(img: Tensor, pix: Tensor):
    """Sample img [H, W] (or [B, H, W]) at float pixels pix [..., 2] and
    return the EXACT gradient of the bilinear interpolant from the same
    corner values: (value, dI/dx, dI/dy). Interpolation weights are zeroed
    at the clamped last row/col (image.py:139-164 of the JAX package) —
    ``F.grid_sample`` treats that edge differently, so it is not used."""
    H, W = img.shape[-2], img.shape[-1]
    x = pix[..., 0]
    y = pix[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = torch.where(x0 >= W - 1, torch.zeros_like(x), x - x0)
    wy = torch.where(y0 >= H - 1, torch.zeros_like(y), y - y0)
    x0i = torch.clamp(x0.to(torch.int64), 0, W - 1)
    y0i = torch.clamp(y0.to(torch.int64), 0, H - 1)
    x1i = torch.clamp(x0i + 1, 0, W - 1)
    y1i = torch.clamp(y0i + 1, 0, H - 1)
    v00 = _gather_flat(img, y0i * W + x0i)
    v01 = _gather_flat(img, y0i * W + x1i)
    v10 = _gather_flat(img, y1i * W + x0i)
    v11 = _gather_flat(img, y1i * W + x1i)
    top = v00 + wx * (v01 - v00)
    bot = v10 + wx * (v11 - v10)
    val = top + wy * (bot - top)
    gx = (1 - wy) * (v01 - v00) + wy * (v11 - v10)
    gy = bot - top
    return val, gx, gy


# ----------------------------------------------------------------------------
# Sobel gradients (cu_image_proc.cpp:57-112)
# ----------------------------------------------------------------------------

_SOBEL_X = np.array([[-1.0, 0.0, 1.0], [-2.0, 0.0, 2.0], [-1.0, 0.0, 1.0]],
                    dtype=np.float32)
_SOBEL_Y = np.array([[-1.0, -2.0, -1.0], [0.0, 0.0, 0.0], [1.0, 2.0, 1.0]],
                    dtype=np.float32)


def _pad_edge(img: Tensor, ph: int, pw: int) -> Tensor:
    """Edge-replicate padding of the last two dims of [..., H, W]."""
    lead = img.shape[:-2]
    x = img.reshape((-1, 1) + img.shape[-2:])
    x = F.pad(x, (pw, pw, ph, ph), mode="replicate")
    return x.reshape(lead + x.shape[-2:])


def _conv2d_clamped(img: Tensor, kernel: np.ndarray) -> Tensor:
    """2D correlation with clamped (edge-replicate) borders over the last
    two dims, as an unrolled shift-multiply-add over the static taps."""
    kh, kw = kernel.shape
    H, W = img.shape[-2], img.shape[-1]
    padded = _pad_edge(img, kh // 2, kw // 2)
    out = torch.zeros_like(img)
    for i in range(kh):
        for j in range(kw):
            if kernel[i, j] != 0.0:
                out = out + float(kernel[i, j]) * padded[..., i:i + H, j:j + W]
    return out


def sobel_gradients(img: Tensor) -> Tensor:
    """[..., H, W] -> [..., H, W, 2] (dx, dy), divided by 8 like the reference."""
    gx = _conv2d_clamped(img, _SOBEL_X) / 8.0
    gy = _conv2d_clamped(img, _SOBEL_Y) / 8.0
    return torch.stack([gx, gy], dim=-1)


# ----------------------------------------------------------------------------
# Gaussian blur + 2x downsample (cu_image_proc.cpp:134-183)
# ----------------------------------------------------------------------------

def gaussian_blur_down(img: Tensor) -> Tensor:
    """[..., H, W] -> [..., H//2, W//2]: 5x5 binomial blur at even pixels
    with clamped taps, /256 (separable: two strided passes of 5 taps)."""
    Ho, Wo = img.shape[-2] // 2, img.shape[-1] // 2
    padded = _pad_edge(img, 2, 2)
    w = (1.0, 4.0, 6.0, 4.0, 1.0)
    rows = torch.zeros(img.shape[:-2] + (Ho, padded.shape[-1]),
                       dtype=img.dtype, device=img.device)
    for i, wi in enumerate(w):
        rows = rows + wi * padded[..., i:i + 2 * Ho:2, :]
    out = torch.zeros(img.shape[:-2] + (Ho, Wo), dtype=img.dtype,
                      device=img.device)
    for j, wj in enumerate(w):
        out = out + wj * rows[..., :, j:j + 2 * Wo:2]
    return out / 256.0


def build_pyramid(img: Tensor, levels: int):
    """Image pyramid [finest..coarsest] via gaussian_blur_down
    (Frame::FillPyramids, frame.h:80-94)."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(gaussian_blur_down(pyr[-1]))
    return pyr


def build_gradient_pyramid(img_pyr):
    return [sobel_gradients(im) for im in img_pyr]


def squared_error(a: Tensor, b: Tensor) -> Tensor:
    d = a - b
    return torch.sum(d * d)


# ----------------------------------------------------------------------------
# UpdateDepth: code -> depth materialization (cu_image_proc.cpp:248-278)
# ----------------------------------------------------------------------------

def update_depth(code: Tensor, prx_orig: Tensor, prx_jac: Tensor,
                 avg_dpt) -> Tensor:
    """dpt[y,x] = ProxToDepth(prx_orig[y,x] + prx_jac[y,x,:]·code, avg_dpt)
    with prx_jac [H, W, CS] (the JAX package's decoder layout)."""
    prx = prx_orig + torch.einsum("hwc,c->hw", prx_jac, code)
    return warping.prox_to_depth(torch.clamp(prx, min=1e-4), avg_dpt)
