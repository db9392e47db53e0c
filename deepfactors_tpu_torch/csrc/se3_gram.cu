// SE(3) dense-tracking linearisation: Gram stacks G[P, 8, 8] for P factors.
//
// Replaces deepfactors_tpu/ops/pallas/sfm_kernel.py::se3_gram_batch
// (:680, body _se3_system_kernel :628-674). Per keyframe pixel it builds the
// row b = [-w*A(6) | w*r | valid] and accumulates G = sum b*b^T, so that
// JtJ = G[:6,:6], Jtr = G[:6,6], residual = G[6,6], inliers = G[7,7].
//
// Bound on the H100: bytes. Per factor the function must read the keyframe
// image and depth plane and the target image (plus two Sobel planes in
// "sampled" mode): 12-20 B per pixel, against ~36 FMA of Gram plus ~60 flops
// of warp math — about 10 flop/B, far below the card's ~20 flop/B fp32
// balance point. At P=1 and 192x256 that is 0.6 MB, 0.18 us of HBM time, so
// a single tracking linearisation is in practice bound by launch latency.
//
// Design: one block of 256 threads per (pixel strip, factor); each thread
// keeps the 36 upper-triangle sums of its pixels in registers, so the image
// planes are read exactly once and coalesced. The block reduces the 36 sums
// with warp shuffles and a fixed-order pass over the warps, and writes one
// partial Gram per strip; a second small kernel sums the strips of each
// factor in a fixed order and mirrors the triangle. No float atomics, so the
// result is bitwise reproducible. Inactive factors (active[p] == 0) skip all
// work and get G = 0. fp32 throughout, no tensor cores: the per-pixel warp
// math rounds op by op (built with --fmad=false, like the plain PyTorch
// twin) and the Gram accumulation uses explicit fmaf().
#include <cuda_runtime.h>

#include "sfm_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;
constexpr int kTri = kRows * (kRows + 1) / 2;  // 36

template <int GRAD_MODE>
__global__ void __launch_bounds__(kThreads)
se3_gram_kernel(const float* __restrict__ params, const int* __restrict__ src,
                const int* __restrict__ dst, const int* __restrict__ active,
                const float* __restrict__ img0, const float* __restrict__ dpt,
                const float* __restrict__ img1, const float* __restrict__ gx1,
                const float* __restrict__ gy1, float* __restrict__ part, int K,
                int K1, int H, int W, int px_per_blk, int nblk) {
  const int p = blockIdx.y;
  const int blk = blockIdx.x;
  if (active[p] == 0) return;
  const int N = H * W;
  const int s = min(max(src[p], 0), K - 1);
  const int d = min(max(dst[p], 0), K1 - 1);
  const dfk::FactorParams f = dfk::load_params(params + p * dfk::kParamDim);
  const float* im0 = img0 + (size_t)s * N;
  const float* dp0 = dpt + (size_t)s * N;
  const float* im1 = img1 + (size_t)d * N;
  const float* g1x = GRAD_MODE ? gx1 + (size_t)d * N : nullptr;
  const float* g1y = GRAD_MODE ? gy1 + (size_t)d * N : nullptr;

  float acc[kTri];
#pragma unroll
  for (int e = 0; e < kTri; ++e) acc[e] = 0.0f;

  const int begin = blk * px_per_blk;
  const int end = min(N, begin + px_per_blk);
  for (int n = begin + threadIdx.x; n < end; n += kThreads) {
    const float xs = (float)(n % W);
    const float ys = (float)(n / W);
    const dfk::Warp w = dfk::correspondence(f, xs, ys, __ldg(dp0 + n), H, W);
    float i1, gx, gy;
    dfk::sample<GRAD_MODE>(im1, g1x, g1y, w.x1, w.y1, H, W, i1, gx, gy);
    float A[6], d00, d02, d11, d12;
    dfk::pose_rows(f, w, gx, gy, A, d00, d02, d11, d12);
    const float r = __ldg(im0 + n) - i1;
    const float wv = dfk::robust_wv<0>(r, w.valid, f.huber);
    float b[kRows];
#pragma unroll
    for (int k = 0; k < 6; ++k) b[k] = -wv * A[k];
    b[6] = wv * r;
    b[7] = w.valid ? 1.0f : 0.0f;
    int e = 0;
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
#pragma unroll
      for (int j = i; j < kRows; ++j, ++e) acc[e] = fmaf(b[i], b[j], acc[e]);
    }
  }

  // block reduction: warp shuffles, then a fixed-order sum over the warps
  __shared__ float warp_sums[kThreads / 32][kTri];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int e = 0; e < kTri; ++e) {
    float v = acc[e];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sums[warp][e] = v;
  }
  __syncthreads();
  if (threadIdx.x < kTri) {
    float v = 0.0f;
#pragma unroll
    for (int k = 0; k < kThreads / 32; ++k) v += warp_sums[k][threadIdx.x];
    part[((size_t)p * nblk + blk) * kTri + threadIdx.x] = v;
  }
}

// G[p] = mirror(sum over strips of part[p]); zero for inactive factors.
__global__ void se3_gram_reduce(const int* __restrict__ active,
                                const float* __restrict__ part,
                                float* __restrict__ G, int nblk) {
  const int p = blockIdx.x;
  const int e = threadIdx.x;
  if (e >= kTri) return;
  float v = 0.0f;
  if (active[p] != 0) {
    for (int k = 0; k < nblk; ++k) v += part[((size_t)p * nblk + k) * kTri + e];
  }
  int i = 0, rem = e;
  while (rem >= kRows - i) {
    rem -= kRows - i;
    ++i;
  }
  const int j = i + rem;
  G[(size_t)p * kRows * kRows + i * kRows + j] = v;
  G[(size_t)p * kRows * kRows + j * kRows + i] = v;
}

}  // namespace

extern "C" int se3_gram_launch(const float* params, const int* src,
                               const int* dst, const int* active,
                               const float* img0, const float* dpt,
                               const float* img1, const float* gx1,
                               const float* gy1, float* part, float* G, int P,
                               int K, int K1, int H, int W, int px_per_blk,
                               int nblk, int grad_mode, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(nblk, P);
  if (grad_mode == 0) {
    se3_gram_kernel<0><<<grid, kThreads, 0, st>>>(
        params, src, dst, active, img0, dpt, img1, gx1, gy1, part, K, K1, H, W,
        px_per_blk, nblk);
  } else {
    se3_gram_kernel<1><<<grid, kThreads, 0, st>>>(
        params, src, dst, active, img0, dpt, img1, gx1, gy1, part, K, K1, H, W,
        px_per_blk, nblk);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  se3_gram_reduce<<<P, 64, 0, st>>>(active, part, G, nblk);
  return (int)cudaGetLastError();
}

extern "C" const char* se3_gram_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
