// Dense warp sampling for the unfused photometric linearisation: the
// correspondence of every keyframe pixel and clamped bilinear samples of the
// target image and its Sobel planes there, written out as whole planes.
//
// Replaces the two kernels of deepfactors_tpu/ops/pallas/warp_kernel.py:
//   dense_warp_batch (:280, body _dense_warp_kernel :166-276): per factor,
//     FindCorrespondence (warping.h:204-241) from a packed params row, then
//     samples of img1, gx1, gy1; outputs i1, gx, gy, tptx, tpty, tptz and
//     valid (0/1), each [P, H, W];
//   bilinear_warp_planes (:125, body _warp_kernel :40-121): the same sample
//     of C planes at given coordinates x1, y1 [H, W].
// The TPU kernels' band gather, `cover` mask and lane rolls were a workaround
// for a gather that works only inside one tile; here every pixel samples its
// four corners directly, so `valid` is the bounds test alone and there is no
// coverage output.
//
// dense_warp_batch divides by tptz with no guard, as the TPU kernel does
// (the fused kernels in sfm_common.cuh substitute 1e-12): at tptz ~ 0 the
// coordinates are huge or not finite, `valid` is false, and `corners` clamps
// them as floats so no thread reads outside a plane. Every output is written
// for every pixel, valid or not (the wrapper allocates uninitialised memory).
//
// Bound on the H100: bytes. Per factor and pixel dense_warp_batch reads 4
// floats and writes 7 (44 B) against ~60 flops, bilinear_warp_planes reads
// C + 2 and writes C: about 1.4 flop/B, far below the card's ~20 flop/B fp32
// balance. At 192x256 that is 2.16 MB a factor (0.65 us of HBM time), so a
// call of a few factors is in practice bound by launch latency.
//
// Design: one thread per output pixel, blocks of 256 consecutive pixels of
// one factor, so every plane is read and written coalesced; the four corner
// taps of the three target planes hit L1/L2 (neighbouring pixels warp to
// neighbouring corners). No reduction, no shared memory beyond the factor's
// params row. fp32 throughout, built with --fmad=false so every expression
// rounds op by op like the plain PyTorch twin.
#include <cuda_runtime.h>

#include "sfm_common.cuh"

namespace {

constexpr int kThreads = 256;
// Row layout of make_warp_params: the first 18 entries of a make_sfm_params
// row (R 0-8, t 9-11, fx fy u0 v0 12-15, border 16, min_dpt 17).
constexpr int kRowUsed = 18;

// out is [7, P, H, W]: i1, gx, gy, tptx, tpty, tptz, valid.
__global__ void __launch_bounds__(kThreads)
dense_warp_kernel(const float* __restrict__ params,
                  const float* __restrict__ dpt0,
                  const float* __restrict__ img1,
                  const float* __restrict__ gx1,
                  const float* __restrict__ gy1, float* __restrict__ out,
                  int P, int H, int W) {
  __shared__ float row[kRowUsed];
  const int p = blockIdx.y;
  if (threadIdx.x < kRowUsed)
    row[threadIdx.x] = params[p * dfk::kParamDim + threadIdx.x];
  __syncthreads();
  const int N = H * W;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const float fx = row[dfk::kFx], fy = row[dfk::kFy];
  const float u0 = row[dfk::kU0], v0 = row[dfk::kV0];
  const float border = row[dfk::kBorder], min_dpt = row[dfk::kMinDpt];

  const size_t base = (size_t)p * N;
  const float xs = (float)(n % W);
  const float ys = (float)(n / W);
  const float dpt = __ldg(dpt0 + base + n);
  const float u = (xs - u0) / fx;
  const float v = (ys - v0) / fy;
  const float ptx = u * dpt;
  const float pty = v * dpt;
  const float tptx = row[0] * ptx + row[1] * pty + row[2] * dpt + row[9];
  const float tpty = row[3] * ptx + row[4] * pty + row[5] * dpt + row[10];
  const float tptz = row[6] * ptx + row[7] * pty + row[8] * dpt + row[11];
  const float x1 = fx * tptx / tptz + u0;
  const float y1 = fy * tpty / tptz + v0;
  const bool valid = (tptz > min_dpt) && (x1 >= border) &&
                     (x1 < (float)W - border) && (y1 >= border) &&
                     (y1 < (float)H - border);

  const dfk::Corners c = dfk::corners(x1, y1, H, W);
  const size_t plane = (size_t)P * N;
  float* o = out + base + n;
  o[0] = dfk::interp_value(img1 + base, c);
  o[plane] = dfk::interp_value(gx1 + base, c);
  o[2 * plane] = dfk::interp_value(gy1 + base, c);
  o[3 * plane] = tptx;
  o[4 * plane] = tpty;
  o[5 * plane] = tptz;
  o[6 * plane] = valid ? 1.0f : 0.0f;
}

// out [C, H, W]: every plane of chans sampled at (x1, y1); the corners are
// computed once per pixel and shared by the C planes.
__global__ void __launch_bounds__(kThreads)
bilinear_warp_kernel(const float* __restrict__ chans,
                     const float* __restrict__ x1,
                     const float* __restrict__ y1, float* __restrict__ out,
                     int C, int H, int W) {
  const int N = H * W;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const dfk::Corners c = dfk::corners(__ldg(x1 + n), __ldg(y1 + n), H, W);
  for (int k = 0; k < C; ++k)
    out[(size_t)k * N + n] = dfk::interp_value(chans + (size_t)k * N, c);
}

}  // namespace

extern "C" int dense_warp_launch(const float* params, const float* dpt0,
                                 const float* img1, const float* gx1,
                                 const float* gy1, float* out, int P, int H,
                                 int W, void* stream) {
  const dim3 grid((H * W + kThreads - 1) / kThreads, P);
  dense_warp_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      params, dpt0, img1, gx1, gy1, out, P, H, W);
  return (int)cudaGetLastError();
}

extern "C" int bilinear_warp_launch(const float* chans, const float* x1,
                                    const float* y1, float* out, int C, int H,
                                    int W, void* stream) {
  const int grid = (H * W + kThreads - 1) / kThreads;
  bilinear_warp_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(chans, x1, y1,
                                                              out, C, H, W);
  return (int)cudaGetLastError();
}

extern "C" const char* dense_warp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
