// Per-pixel photometric warp math shared by se3_gram.cu and sfm_gram.cu.
//
// The device functions below compute, for one keyframe pixel, exactly what
// deepfactors_tpu/ops/pallas/sfm_kernel.py computes per pixel: the
// correspondence of `_correspondence` (:80-108), a bilinear sample of the
// target image at the warp (the gradient of the interpolant in "interp" mode,
// sampled Sobel planes in "sampled" mode), the gradient-contracted pose rows
// of `_pose_rows` (:377-398) and the robust weight of `_huber_wv` (:401-415).
// The TPU kernel's band gather (`_band_sample*`, the `cover` mask) was a
// workaround for Mosaic's in-tile dynamic_gather; here every pixel samples
// the target image directly, so coverage is always complete.
#pragma once

#include <cuda_runtime.h>

namespace dfk {

// Layout of one make_sfm_params row (ops/kernels/sfm_gram.py).
constexpr int kParamDim = 24;
constexpr int kFx = 12, kFy = 13, kU0 = 14, kV0 = 15;
constexpr int kBorder = 16, kMinDpt = 17, kHuber = 18, kAvgDpt = 19;

struct FactorParams {
  float R[9];
  float t[3];
  float fx, fy, u0, v0, border, min_dpt, huber, avg_dpt;
};

__device__ __forceinline__ FactorParams load_params(const float* row) {
  FactorParams f;
#pragma unroll
  for (int k = 0; k < 9; ++k) f.R[k] = row[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) f.t[k] = row[9 + k];
  f.fx = row[kFx];
  f.fy = row[kFy];
  f.u0 = row[kU0];
  f.v0 = row[kV0];
  f.border = row[kBorder];
  f.min_dpt = row[kMinDpt];
  f.huber = row[kHuber];
  f.avg_dpt = row[kAvgDpt];
  return f;
}

struct Warp {
  float x1, y1, iz, u, v, tx, ty, tz;
  bool valid;
};

// FindCorrespondence (warping.h:204-241). Invalid pixels keep their own
// coordinates and iz = 0 so their (zero-weighted) rows stay finite.
__device__ __forceinline__ Warp correspondence(const FactorParams& f, float xs,
                                               float ys, float dpt, int H,
                                               int W) {
  Warp w;
  w.u = (xs - f.u0) / f.fx;
  w.v = (ys - f.v0) / f.fy;
  const float ptx = w.u * dpt;
  const float pty = w.v * dpt;
  w.tx = f.R[0] * ptx + f.R[1] * pty + f.R[2] * dpt + f.t[0];
  w.ty = f.R[3] * ptx + f.R[4] * pty + f.R[5] * dpt + f.t[1];
  w.tz = f.R[6] * ptx + f.R[7] * pty + f.R[8] * dpt + f.t[2];
  const float zsafe = fabsf(w.tz) > 1e-12f ? w.tz : 1e-12f;
  const float x1 = f.fx * w.tx / zsafe + f.u0;
  const float y1 = f.fy * w.ty / zsafe + f.v0;
  w.valid = (w.tz > f.min_dpt) && (x1 >= f.border) &&
            (x1 < (float)W - f.border) && (y1 >= f.border) &&
            (y1 < (float)H - f.border);
  w.x1 = w.valid ? x1 : xs;
  w.y1 = w.valid ? y1 : ys;
  w.iz = w.valid ? 1.0f / zsafe : 0.0f;
  return w;
}

struct Corners {
  int i00, i01, i10, i11;
  float wx, wy;
};

// Bilinear corners with the kernel's edge convention: the interpolation
// weight is zeroed at the clamped last row/column (image.bilinear_sample_grad).
// The floor is clamped as a float, before the cast: a coordinate beyond
// int's range, or NaN (fmaxf returns its other argument), has no defined
// conversion, and dense_warp.cu samples at unguarded coordinates.
__device__ __forceinline__ Corners corners(float x, float y, int H, int W) {
  Corners c;
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  c.wx = (x0f >= (float)(W - 1)) ? 0.0f : x - x0f;
  c.wy = (y0f >= (float)(H - 1)) ? 0.0f : y - y0f;
  const int x0 = (int)fminf(fmaxf(x0f, 0.0f), (float)(W - 1));
  const int y0 = (int)fminf(fmaxf(y0f, 0.0f), (float)(H - 1));
  const int x1 = min(x0 + 1, W - 1);
  const int y1 = min(y0 + 1, H - 1);
  c.i00 = y0 * W + x0;
  c.i01 = y0 * W + x1;
  c.i10 = y1 * W + x0;
  c.i11 = y1 * W + x1;
  return c;
}

__device__ __forceinline__ float interp_value(const float* __restrict__ img,
                                              const Corners& c) {
  const float v00 = __ldg(img + c.i00), v01 = __ldg(img + c.i01);
  const float v10 = __ldg(img + c.i10), v11 = __ldg(img + c.i11);
  const float top = v00 + c.wx * (v01 - v00);
  const float bot = v10 + c.wx * (v11 - v10);
  return top + c.wy * (bot - top);
}

// Sample (value, dI/dx, dI/dy) at the warp. grad_mode 0 ("interp"): the
// exact gradient of the bilinear interpolant. grad_mode 1 ("sampled"): the
// Sobel planes gx1/gy1 sampled at the same corners.
template <int GRAD_MODE>
__device__ __forceinline__ void sample(const float* __restrict__ img1,
                                       const float* __restrict__ gx1,
                                       const float* __restrict__ gy1,
                                       float x, float y, int H, int W,
                                       float& val, float& gx, float& gy) {
  const Corners c = corners(x, y, H, W);
  if (GRAD_MODE == 0) {
    const float v00 = __ldg(img1 + c.i00), v01 = __ldg(img1 + c.i01);
    const float v10 = __ldg(img1 + c.i10), v11 = __ldg(img1 + c.i11);
    const float top = v00 + c.wx * (v01 - v00);
    const float bot = v10 + c.wx * (v11 - v10);
    val = top + c.wy * (bot - top);
    gx = (1.0f - c.wy) * (v01 - v00) + c.wy * (v11 - v10);
    gy = bot - top;
  } else {
    val = interp_value(img1, c);
    gx = interp_value(gx1, c);
    gy = interp_value(gy1, c);
  }
}

// Gradient-contracted warp Jacobian rows A[6] w.r.t. pose_10 and the
// projection terms reused by the depth chain (dense_sfm.h:124-201).
__device__ __forceinline__ void pose_rows(const FactorParams& f, const Warp& w,
                                          float gx, float gy, float A[6],
                                          float& d00, float& d02, float& d11,
                                          float& d12) {
  d00 = f.fx * w.iz;
  d02 = -f.fx * w.tx * w.iz * w.iz;
  d11 = f.fy * w.iz;
  d12 = -f.fy * w.ty * w.iz * w.iz;
  const float gd0 = gx * d00;
  const float gd1 = gy * d11;
  const float gd2 = gx * d02 + gy * d12;
  const float vx = w.tx - f.t[0];
  const float vy = w.ty - f.t[1];
  const float vz = w.tz - f.t[2];
  A[0] = gd0;
  A[1] = gd1;
  A[2] = gd2;
  A[3] = -gd1 * vz + gd2 * vy;
  A[4] = gd0 * vz - gd2 * vx;
  A[5] = -gd0 * vy + gd1 * vx;
}

// Square-root IRLS weight zeroed on invalid pixels: loss 0 = Huber
// (m_estimators.h:50-56), loss 1 = Tukey biweight w = max(0, 1 - (r/d)^2).
template <int LOSS>
__device__ __forceinline__ float robust_wv(float r, bool valid, float delta) {
  float w;
  if (LOSS == 1) {
    const float a = r / delta;
    w = fmaxf(0.0f, 1.0f - a * a);
  } else {
    const float aa = fabsf(r);
    const float hub = sqrtf(delta * (2.0f * aa - delta)) / fmaxf(aa, 1e-12f);
    w = (aa <= delta) ? 1.0f : hub;
  }
  return valid ? w : 0.0f;
}

}  // namespace dfk
