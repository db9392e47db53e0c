// Photometric error evaluation and warp render for P factors, no Jacobians.
//
// Replaces two kernels of deepfactors_tpu/ops/pallas/sfm_kernel.py:
//   sfm_error_batch (:783, body _sfm_error_kernel :746-779): per factor the
//     Huber-weighted residual sum((w*r)^2) and the inlier count sum(valid),
//     r = img0 - img1(warp), w zeroed on invalid pixels;
//   se3_warp_batch (:874, body _se3_warp_kernel :834-870): the render
//     warped = valid ? img1(warp) : 0, with the unweighted sum(r^2) over
//     valid pixels and sum(valid).
// Both take the correspondence's border and min_dpt from the params row.
//
// Bound on the H100: bytes. Per factor and pixel the error kernel must read
// 12 B (img0, dpt, img1) and the warp kernel must also write 4 B, against
// ~50 flops of warp math: ~4 flop/B, far below the card's ~20 flop/B fp32
// balance point. At P = 2 and 192x256 (the keyframe gate: two hypotheses
// sharing one target plane) that is 1.0 MB, 0.29 us of HBM time, so a call
// is in practice bound by launch latency.
//
// Design: one block of 256 threads per (pixel strip, factor). Each thread
// keeps its two sums in registers, so every plane is read once, coalesced
// (the bilinear taps of img1 hit L1/L2). Warps reduce with shuffles, the
// block sums its warps in a fixed order and writes one partial pair per
// strip; a second small kernel sums the strips of each factor in a fixed
// order. No float atomics: results repeat bit for bit. An inactive factor
// (active[p] == 0) reads no plane; its sums are 0 and, in the warp kernel,
// its blocks write zeros to `warped` (the output is uninitialised memory).
// fp32 throughout, built with --fmad=false so each expression rounds op by
// op like the plain PyTorch twin; the sums accumulate with explicit fmaf().
#include <cuda_runtime.h>

#include "sfm_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// WARP == 0: sfm_error_batch. WARP == 1: se3_warp_batch (writes `warped`).
template <int WARP>
__global__ void __launch_bounds__(kThreads)
sfm_error_kernel(const float* __restrict__ params, const int* __restrict__ src,
                 const int* __restrict__ dst, const int* __restrict__ active,
                 const float* __restrict__ img0, const float* __restrict__ dpt,
                 const float* __restrict__ img1, float* __restrict__ warped,
                 float* __restrict__ part, int K, int K1, int H, int W,
                 int px_per_blk, int nblk) {
  const int p = blockIdx.y;
  const int blk = blockIdx.x;
  const int N = H * W;
  const int begin = blk * px_per_blk;
  const int end = min(N, begin + px_per_blk);
  if (active[p] == 0) {
    if (WARP) {
      float* out = warped + (size_t)p * N;
      for (int n = begin + threadIdx.x; n < end; n += kThreads) out[n] = 0.0f;
    }
    return;
  }
  const int s = min(max(src[p], 0), K - 1);
  const int d = min(max(dst[p], 0), K1 - 1);
  const dfk::FactorParams f = dfk::load_params(params + p * dfk::kParamDim);
  const float* im0 = img0 + (size_t)s * N;
  const float* dp0 = dpt + (size_t)s * N;
  const float* im1 = img1 + (size_t)d * N;

  float sum_r = 0.0f, sum_v = 0.0f;
  for (int n = begin + threadIdx.x; n < end; n += kThreads) {
    const float xs = (float)(n % W);
    const float ys = (float)(n / W);
    const dfk::Warp w = dfk::correspondence(f, xs, ys, __ldg(dp0 + n), H, W);
    const dfk::Corners c = dfk::corners(w.x1, w.y1, H, W);
    const float i1 = dfk::interp_value(im1, c);
    const float r = __ldg(im0 + n) - i1;
    float e;
    if (WARP) {
      warped[(size_t)p * N + n] = w.valid ? i1 : 0.0f;
      e = w.valid ? r : 0.0f;
    } else {
      e = dfk::robust_wv<0>(r, w.valid, f.huber) * r;
    }
    sum_r = fmaf(e, e, sum_r);
    sum_v += w.valid ? 1.0f : 0.0f;
  }

  // block reduction: warp shuffles, then a fixed-order sum over the warps
  __shared__ float warp_sums[kWarps][2];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum_r += __shfl_down_sync(0xffffffffu, sum_r, off);
    sum_v += __shfl_down_sync(0xffffffffu, sum_v, off);
  }
  if (lane == 0) {
    warp_sums[warp][0] = sum_r;
    warp_sums[warp][1] = sum_v;
  }
  __syncthreads();
  if (threadIdx.x < 2) {
    float v = 0.0f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) v += warp_sums[k][threadIdx.x];
    part[((size_t)p * nblk + blk) * 2 + threadIdx.x] = v;
  }
}

// out[p] = (sum over strips of part[p]); zero for inactive factors.
__global__ void sfm_error_reduce(const int* __restrict__ active,
                                 const float* __restrict__ part,
                                 float* __restrict__ out, int P, int nblk) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * P) return;
  const int p = i >> 1;
  const int e = i & 1;
  float v = 0.0f;
  if (active[p] != 0) {
    for (int k = 0; k < nblk; ++k) v += part[((size_t)p * nblk + k) * 2 + e];
  }
  out[i] = v;
}

}  // namespace

// out [P, 2] = (residual, inliers). warp_mode 0: sfm_error_batch (warped is
// unused and may be null); 1: se3_warp_batch, warped [P, H, W].
extern "C" int sfm_error_launch(const float* params, const int* src,
                                const int* dst, const int* active,
                                const float* img0, const float* dpt,
                                const float* img1, float* warped, float* part,
                                float* out, int P, int K, int K1, int H, int W,
                                int px_per_blk, int nblk, int warp_mode,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(nblk, P);
  if (warp_mode == 0) {
    sfm_error_kernel<0><<<grid, kThreads, 0, st>>>(
        params, src, dst, active, img0, dpt, img1, warped, part, K, K1, H, W,
        px_per_blk, nblk);
  } else {
    sfm_error_kernel<1><<<grid, kThreads, 0, st>>>(
        params, src, dst, active, img0, dpt, img1, warped, part, K, K1, H, W,
        px_per_blk, nblk);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sfm_error_reduce<<<(2 * P + 127) / 128, 128, 0, st>>>(active, part, out, P,
                                                         nblk);
  return (int)cudaGetLastError();
}

extern "C" const char* sfm_error_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
