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
// is bound by latency: the launch and one chain of dependent round trips.
//
// Design (one launch):
//  - The grid is [strips, P] blocks of 256 threads, one pixel a thread; a
//    thread takes up to 4 pixels (their loads issued together) only where
//    the blocks of all P factors would not be resident at once (4 blocks an
//    SM at 64 registers). The geometry (pixels a strip, strips a factor)
//    comes from the wrapper's sfm_gram.launch_plan; this source derives
//    none of it and only checks it.
//  - A block loads its factor's scalars before it branches on active[p].
//    A thread finds its first pixel's row with one division and steps on
//    from there.
//  - Each thread sums its pixels in order (fmaf for the squares); the block
//    reduces with warp shuffles, then its warps in order, and writes one
//    partial pair per strip. The last block of a factor to finish (an
//    integer ticket: __threadfence, atomicAdd on an int) reads the strips'
//    partials with __ldcg, one a thread, sums them in the same order as the
//    pixels, writes out[p] and resets the ticket. No float atomics: results
//    repeat bit for bit. The tickets belong to the wrapper, one buffer per
//    stream, shared with the Gram kernels (launches on one stream are
//    ordered, and each leaves its tickets at zero).
//  - An inactive factor (active[p] == 0) reads no plane: block 0 writes its
//    zero sums and, in the warp kernel, every block writes its strip's zeros
//    to `warped` (the output is uninitialised memory).
//  - fp32 throughout, built with --fmad=false so each expression rounds op
//    by op like the plain PyTorch twin (validity and inlier counts are
//    bit-identical to it).
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W limit
// (port_tools/compare_designs.py, in turns with the first design, which
// took two launches and 1,024 pixels a block): the keyframe gate (P = 2)
// 5.9 / 5.5 / 5.5 us at 192x256 / 96x128 / 48x64 (first design 9.0 / 8.4 /
// 8.3), one render (P = 1) 5.2 / 5.1 / 5.1 us (7.9 / 7.7 / 7.4), the map
// dump (P = 64, 32 active) 23.9 / 10.4 / 7.0 us (23.9 / 11.6 / 9.1); an
// empty launch 1.7 us. The dump is bound by the latency of its blocks (4
// an SM), not by bytes: at one pixel a thread it takes ~45 us, and the
// exact divisions and the gathers each cost ~4 us of its 24.
#include <cuda_runtime.h>

#include "sfm_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 4;   // pixels a thread loads before it samples any

// (a, b) summed over the block in a fixed order: warp shuffles, then the
// warps in order. The totals land in thread 0 (a) and thread 1 (b). ``ws``
// may be reused after the block's next __syncthreads().
__device__ __forceinline__ float block_sum2(float a, float b,
                                            float (*ws)[2]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, off);
    b += __shfl_down_sync(0xffffffffu, b, off);
  }
  if (lane == 0) {
    ws[warp][0] = a;
    ws[warp][1] = b;
  }
  __syncthreads();
  float v = 0.0f;
  if (threadIdx.x < 2) {
#pragma unroll
    for (int k = 0; k < kWarps; ++k) v += ws[k][threadIdx.x];
  }
  return v;
}

// WARP == 0: sfm_error_batch. WARP == 1: se3_warp_batch (writes `warped`).
template <int WARP>
__global__ void __launch_bounds__(kThreads, 4)
sfm_error_kernel(const float* __restrict__ params, const int* __restrict__ src,
                 const int* __restrict__ dst, const int* __restrict__ active,
                 const float* __restrict__ img0, const float* __restrict__ dpt,
                 const float* __restrict__ img1, float* __restrict__ warped,
                 float* part, float* __restrict__ out, int* tickets, int K,
                 int K1, int H, int W, int px_per_blk, int nblk) {
  __shared__ float warp_sums[kWarps][2];
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
  const int N = H * W;
  const int begin = blk * px_per_blk;
  const int end = min(N, begin + px_per_blk);
  if (on == 0) {
    if (WARP) {
      float* o = warped + (size_t)p * N;
      for (int n = begin + tid; n < end; n += kThreads) o[n] = 0.0f;
    }
    if (blk == 0 && tid < 2) out[p * 2 + tid] = 0.0f;
    return;
  }
  const float* im0 = img0 + (size_t)s * N;
  const float* dp0 = dpt + (size_t)s * N;
  const float* im1 = img1 + (size_t)d * N;
  float* wp = WARP ? warped + (size_t)p * N : nullptr;

  float sum_r = 0.0f, sum_v = 0.0f;
  int y = (begin + tid) / W;
  int x = begin + tid - y * W;
  for (int base = begin + tid; base < end; base += kBatch * kThreads) {
    float dv[kBatch], iv[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int n = base + j * kThreads;
      dv[j] = n < end ? __ldg(dp0 + n) : 0.0f;
      iv[j] = n < end ? __ldg(im0 + n) : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int n = base + j * kThreads;
      if (n < end) {
        const dfk::Warp w =
            dfk::correspondence(f, (float)x, (float)y, dv[j], H, W);
        const float i1 = dfk::interp_value(im1, dfk::corners(w.x1, w.y1, H, W));
        const float r = iv[j] - i1;
        float e;
        if (WARP) {
          wp[n] = w.valid ? i1 : 0.0f;
          e = w.valid ? r : 0.0f;
        } else {
          e = dfk::robust_wv<0>(r, w.valid, f.huber) * r;
        }
        sum_r = fmaf(e, e, sum_r);
        sum_v += w.valid ? 1.0f : 0.0f;
      }
      x += kThreads;
      while (x >= W) {
        x -= W;
        ++y;
      }
    }
  }

  const float strip = block_sum2(sum_r, sum_v, warp_sums);
  if (tid < 2) part[((size_t)p * nblk + blk) * 2 + tid] = strip;

  // ticket: the last block of the factor sums the strips and writes out[p]
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(tickets + p, 1) == nblk - 1;
  __syncthreads();
  if (!is_last) return;
  if (tid == 0) tickets[p] = 0;
  __threadfence();
  // one strip's partial a thread (nblk <= kThreads), summed in the same
  // order as the pixels
  float2 sv = make_float2(0.0f, 0.0f);
  if (tid < nblk)
    sv = __ldcg(reinterpret_cast<const float2*>(part) + (size_t)p * nblk + tid);
  const float total = block_sum2(sv.x, sv.y, warp_sums);
  if (tid < 2) out[p * 2 + tid] = total;
}

}  // namespace

// out [P, 2] = (residual, inliers). warp_mode 0: sfm_error_batch (warped is
// unused and may be null); 1: se3_warp_batch, warped [P, H, W]. active may
// be null: every factor is active. part [P, nblk, 2] is scratch; tickets
// [>= P] int32, all zero, left at zero.
extern "C" int sfm_error_launch(const float* params, const int* src,
                                const int* dst, const int* active,
                                const float* img0, const float* dpt,
                                const float* img1, float* warped, float* part,
                                float* out, int* tickets, int P, int K, int K1,
                                int H, int W, int px_per_blk, int nblk,
                                int warp_mode, void* stream) {
  if (px_per_blk < 1 || nblk < 1 || nblk > kThreads ||
      (long long)nblk * px_per_blk < (long long)H * W)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(nblk, P);
  if (warp_mode == 0) {
    sfm_error_kernel<0><<<grid, kThreads, 0, st>>>(
        params, src, dst, active, img0, dpt, img1, warped, part, out, tickets,
        K, K1, H, W, px_per_blk, nblk);
  } else {
    sfm_error_kernel<1><<<grid, kThreads, 0, st>>>(
        params, src, dst, active, img0, dpt, img1, warped, part, out, tickets,
        K, K1, H, W, px_per_blk, nblk);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* sfm_error_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
