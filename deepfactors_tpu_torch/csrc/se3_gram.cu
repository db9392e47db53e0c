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
// a single tracking linearisation is bound by latency: the launch itself and
// the chain depth -> projection -> four gathers of one pixel.
//
// Design (one launch):
//  - The grid is sized to the card, [strips, P] blocks of 256 threads with
//    one pixel a thread (more only when the blocks of all P factors would
//    not be resident at once: two blocks an SM at ~100 registers a thread),
//    so every pixel's loads are in flight together instead of one thread
//    walking 12 pixels one after another.
//  - Each thread keeps the 36 upper-triangle sums in registers. The block
//    reduces them through shared memory, transposed ([sum][thread], odd row
//    stride): seven groups of 36 threads each add a run of 37 threads'
//    values in thread order, then 36 threads add the seven group sums in
//    group order and write the strip's partial.
//  - The last block of a factor to finish (an integer ticket per factor:
//    __threadfence, atomicAdd on an int) sums the strips' partials in the
//    same grouped fixed order, mirrors the triangle, writes G and resets
//    the ticket. No float atomics, so the result is bitwise reproducible.
//    The ticket buffer belongs to the wrapper, one per stream; calls on one
//    stream are ordered, so a ticket is always 0 when a launch starts.
//  - Inactive factors (active[p] == 0) skip all work; block 0 writes G = 0.
//    A null active takes every factor as active.
//  - fp32 throughout, no tensor cores: the per-pixel warp math rounds op by
//    op (built with --fmad=false, like the plain PyTorch twin) and the Gram
//    accumulation uses explicit fmaf().
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W limit: 7.5 / 6.9 / 6.2 us
// at P = 1 and 192x256 / 96x128 / 48x64 (bound 0.18 / 0.04 / 0.01 us; an
// empty launch 1.7-1.85 us; the first design of this kernel, two launches:
// 17.2 / 9.8 / 9.8 us), 13.4 / 8.1 / 6.4 us at P = 8 with sampled gradients.
// What is left above the launch is the chain of dependent memory round
// trips: indices, depth, gathers, partial, fence and ticket, partials, G.
#include <cuda_runtime.h>

#include "sfm_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;
constexpr int kTri = kRows * (kRows + 1) / 2;            // 36
constexpr int kGroups = kThreads / kTri;                 // 7
constexpr int kRedStride = kThreads + 1;

// Sum ``count`` values v(0..count-1) for sum index e = tid % 36 in a fixed
// order: group g = tid / 36 adds v(g * run ..) in order into grp[g][e], then
// threads 0..35 add the groups in order. Returns the total in threads 0..35.
template <typename F>
__device__ __forceinline__ float grouped_sum(F v, int count,
                                             float (*grp)[kTri]) {
  const int e = threadIdx.x % kTri;
  const int g = threadIdx.x / kTri;
  if (g < kGroups) {
    const int run = (count + kGroups - 1) / kGroups;
    const int hi = min(count, (g + 1) * run);
    float s = 0.0f;
    int k = g * run;
    for (; k + 8 <= hi; k += 8) {      // eight loads in flight, added in order
      float x[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = v(k + i, e);
#pragma unroll
      for (int i = 0; i < 8; ++i) s += x[i];
    }
    for (; k < hi; ++k) s += v(k, e);
    grp[g][e] = s;
  }
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x < kTri) {
#pragma unroll
    for (int k = 0; k < kGroups; ++k) total += grp[k][threadIdx.x];
  }
  return total;
}

template <int GRAD_MODE>
__global__ void __launch_bounds__(kThreads)
se3_gram_kernel(const float* __restrict__ params, const int* __restrict__ src,
                const int* __restrict__ dst, const int* __restrict__ active,
                const float* __restrict__ img0, const float* __restrict__ dpt,
                const float* __restrict__ img1, const float* __restrict__ gx1,
                const float* __restrict__ gy1, float* part,
                float* __restrict__ G, int* tickets, int K, int K1, int H,
                int W, int px_per_blk, int nblk) {
  __shared__ float red[kTri * kRedStride];     // [sum][thread]
  __shared__ float grp[kGroups][kTri];
  __shared__ int is_last;
  const int p = blockIdx.y;
  const int blk = blockIdx.x;
  const int tid = threadIdx.x;
  // the factor's scalars are loaded before the branch on ``active`` so that
  // all of them are in flight at once
  const int on = active ? active[p] : 1;
  const int s = min(max(src[p], 0), K - 1);
  const int d = min(max(dst[p], 0), K1 - 1);
  const dfk::FactorParams f = dfk::load_params(params + p * dfk::kParamDim);
  if (on == 0) {
    if (blk == 0 && tid < kRows * kRows) G[(size_t)p * kRows * kRows + tid] = 0.0f;
    return;
  }
  const int N = H * W;
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
  for (int n = begin + tid; n < end; n += kThreads) {
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

  // block reduction through shared memory, transposed, in thread order
#pragma unroll
  for (int e = 0; e < kTri; ++e) red[e * kRedStride + tid] = acc[e];
  __syncthreads();
  const float strip = grouped_sum(
      [&](int k, int e) { return red[e * kRedStride + k]; }, kThreads, grp);
  float* out = part + ((size_t)p * nblk + blk) * kTri;
  if (tid < kTri) out[tid] = strip;

  // ticket: the last block of the factor sums the strips and writes G
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(tickets + p, 1) == nblk - 1;
  __syncthreads();
  if (!is_last) return;
  if (tid == 0) tickets[p] = 0;
  __threadfence();
  const float* all = part + (size_t)p * nblk * kTri;
  const float v = grouped_sum(
      [&](int k, int e) { return __ldcg(all + k * kTri + e); }, nblk, grp);
  if (tid < kTri) {
    int i = 0, rem = tid;
    while (rem >= kRows - i) {
      rem -= kRows - i;
      ++i;
    }
    const int j = i + rem;
    float* g = G + (size_t)p * kRows * kRows;
    g[i * kRows + j] = v;
    g[j * kRows + i] = v;
  }
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" int se3_gram_launch(const float* params, const int* src,
                               const int* dst, const int* active,
                               const float* img0, const float* dpt,
                               const float* img1, const float* gx1,
                               const float* gy1, float* part, float* G,
                               int* tickets, int P, int K, int K1, int H,
                               int W, int px_per_blk, int nblk, int grad_mode,
                               void* stream) {
  if (px_per_blk < 1 || (long long)nblk * px_per_blk < (long long)H * W)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(nblk, P);
  if (grad_mode == 0) {
    se3_gram_kernel<0><<<grid, kThreads, 0, st>>>(
        params, src, dst, active, img0, dpt, img1, gx1, gy1, part, G, tickets,
        K, K1, H, W, px_per_blk, nblk);
  } else {
    se3_gram_kernel<1><<<grid, kThreads, 0, st>>>(
        params, src, dst, active, img0, dpt, img1, gx1, gy1, part, G, tickets,
        K, K1, H, W, px_per_blk, nblk);
  }
  return (int)cudaGetLastError();
}

// One launch of a kernel that does nothing: the floor under any single
// launch on this card, timed beside se3_gram_batch.
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

extern "C" const char* se3_gram_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
