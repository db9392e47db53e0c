// Photometric BA linearisation: Gram stacks G[P, R, R], R = 6 + CS + 2, for
// P keyframe->target factors read straight from the keyframe pools.
//
// Replaces deepfactors_tpu/ops/pallas/sfm_kernel.py::sfm_gram_batch
// (:545, body _sfm_system_kernel :444-526). Per source pixel it builds the
// row b = [w*A(6) | w*err_J_prx*jac(CS) | w*r | valid] (A: gradient-
// contracted pose rows; err_J_prx: the depth chain of warping.h:259-291;
// w: Huber or Tukey square-root weight) and accumulates G = sum b*b^T.
// With codes given, depth is materialised in-kernel from the zero-code
// proximity: dpt = avg / max(prx0 + jac^T c, 1e-4) - avg.
//
// Bound on the H100: operations. Per active factor pixel the Gram takes
// R(R+1)/2 = 820 FMA at CS=32 (1640 flop) against 4*(CS+3) = 140 bytes read
// (jac^T dominates: 32 x 192 x 256 x 4 B = 6.3 MB per factor at level 0):
// ~12 flop/B, just under the card's fp32 balance point (67 TFLOP/s over
// 3.35 TB/s = 20 flop/B), so the FMA pipe bounds the kernel once the rows
// are on chip: 64 active factors at level 0 are 5.2 GFLOP, 77 us at peak.
//
// Design: one block of 256 threads per (pixel strip, factor). For each tile
// of 256 pixels every thread computes its pixel's row into shared memory
// (R rows x 257 floats: the odd stride spreads the rows over the banks, so a
// warp reading 32 different rows at one pixel is conflict-free), then each
// thread accumulates its own few of the R(R+1)/2 upper-triangle (i, j) pairs
// over the tile's 256 pixels in registers. The jac^T planes are read once,
// coalesced, and never leave the chip as rows. Each block writes one partial
// Gram per strip; a second small kernel sums the strips of each factor in a
// fixed order and mirrors the triangle. No float atomics, so the result is
// bitwise reproducible. Inactive factors skip all work and get G = 0.
// fp32 throughout, no tensor cores: the per-pixel math rounds op by op
// (built with --fmad=false, like the plain PyTorch twin) and the Gram
// accumulation uses explicit fmaf(). CS is a runtime argument up to 64.
#include <cuda_runtime.h>

#include "sfm_common.cuh"

namespace {

constexpr int kThreads = 256;                  // pixels per tile
constexpr int kStride = kThreads + 1;          // shared row stride (floats)
constexpr int kMaxCS = 64;
constexpr int kMaxRows = kMaxCS + 8;
constexpr int kMaxPairs =
    (kMaxRows * (kMaxRows + 1) / 2 + kThreads - 1) / kThreads;  // 11

// (i, j) of upper-triangle entry e in row-major order of a R x R matrix.
__device__ __forceinline__ void tri_index(int e, int R, int& i, int& j) {
  i = 0;
  while (e >= R - i) {
    e -= R - i;
    ++i;
  }
  j = i + e;
}

template <int GRAD_MODE, int LOSS, bool FROM_PROX>
__global__ void __launch_bounds__(kThreads)
sfm_gram_kernel(const float* __restrict__ params, const int* __restrict__ src,
                const int* __restrict__ dst, const int* __restrict__ active,
                const float* __restrict__ codes,
                const float* __restrict__ img0, const float* __restrict__ dpt,
                const float* __restrict__ jac, const float* __restrict__ img1,
                const float* __restrict__ gx1, const float* __restrict__ gy1,
                float* __restrict__ part, int K, int K1, int CS, int H, int W,
                int px_per_blk, int nblk) {
  extern __shared__ float sh[];
  const int p = blockIdx.y;
  const int blk = blockIdx.x;
  if (active[p] == 0) return;
  const int tid = threadIdx.x;
  const int R = CS + 8;
  const int ntri = R * (R + 1) / 2;
  const int N = H * W;
  float* rows = sh;                       // [R][kStride]
  float* code_sh = sh + R * kStride;      // [CS]
  const int s = min(max(src[p], 0), K - 1);
  const int d = min(max(dst[p], 0), K1 - 1);
  const dfk::FactorParams f = dfk::load_params(params + p * dfk::kParamDim);
  const float* im0 = img0 + (size_t)s * N;
  const float* dp0 = dpt + (size_t)s * N;
  const float* jc0 = jac + (size_t)s * CS * N;
  const float* im1 = img1 + (size_t)d * N;
  const float* g1x = GRAD_MODE ? gx1 + (size_t)d * N : nullptr;
  const float* g1y = GRAD_MODE ? gy1 + (size_t)d * N : nullptr;
  if (FROM_PROX) {
    for (int c = tid; c < CS; c += kThreads) code_sh[c] = codes[p * CS + c];
  }

  int pi[kMaxPairs], pj[kMaxPairs];
  float acc[kMaxPairs];
#pragma unroll
  for (int m = 0; m < kMaxPairs; ++m) {
    acc[m] = 0.0f;
    pi[m] = 0;
    pj[m] = 0;
    const int e = tid + m * kThreads;
    if (e < ntri) tri_index(e, R, pi[m], pj[m]);
  }
  __syncthreads();

  const int begin = blk * px_per_blk;
  const int end = min(N, begin + px_per_blk);
  for (int tile = begin; tile < end; tile += kThreads) {
    const int n = tile + tid;
    if (n < end) {
      const float xs = (float)(n % W);
      const float ys = (float)(n / W);
      // jac^T rows into shared memory; from-prox depth on the way
      float prx = FROM_PROX ? __ldg(dp0 + n) : 0.0f;
      for (int c = 0; c < CS; ++c) {
        const float jv = __ldg(jc0 + (size_t)c * N + n);
        rows[(6 + c) * kStride + tid] = jv;
        if (FROM_PROX) prx = prx + code_sh[c] * jv;
      }
      float depth;
      if (FROM_PROX) {
        prx = fmaxf(prx, 1e-4f);
        depth = f.avg_dpt / prx - f.avg_dpt;
      } else {
        depth = __ldg(dp0 + n);
      }
      const dfk::Warp w = dfk::correspondence(f, xs, ys, depth, H, W);
      float i1, gx, gy;
      dfk::sample<GRAD_MODE>(im1, g1x, g1y, w.x1, w.y1, H, W, i1, gx, gy);
      float A[6], d00, d02, d11, d12;
      dfk::pose_rows(f, w, gx, gy, A, d00, d02, d11, d12);
      // depth chain: err_J_prx = -(grad . dCam . R . ray) * d dpt / d prx
      const float m0 = f.R[0] * w.u + f.R[1] * w.v + f.R[2];
      const float m1 = f.R[3] * w.u + f.R[4] * w.v + f.R[5];
      const float m2 = f.R[6] * w.u + f.R[7] * w.v + f.R[8];
      const float pjd0 = d00 * m0 + d02 * m2;
      const float pjd1 = d11 * m1 + d12 * m2;
      const float ad = f.avg_dpt + depth;
      const float dpt_J_prx = -(ad * ad) / f.avg_dpt;
      const float err_J_prx = -(gx * pjd0 + gy * pjd1) * dpt_J_prx;
      const float r = __ldg(im0 + n) - i1;
      const float wv = dfk::robust_wv<LOSS>(r, w.valid, f.huber);
#pragma unroll
      for (int k = 0; k < 6; ++k) rows[k * kStride + tid] = wv * A[k];
      const float sc = wv * err_J_prx;
      for (int c = 0; c < CS; ++c) rows[(6 + c) * kStride + tid] *= sc;
      rows[(6 + CS) * kStride + tid] = wv * r;
      rows[(7 + CS) * kStride + tid] = w.valid ? 1.0f : 0.0f;
    } else {
      for (int k = 0; k < R; ++k) rows[k * kStride + tid] = 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < kMaxPairs; ++m) {
      if (tid + m * kThreads < ntri) {
        const float* a = rows + pi[m] * kStride;
        const float* b = rows + pj[m] * kStride;
        float v = acc[m];
#pragma unroll 8
        for (int k = 0; k < kThreads; ++k) v = fmaf(a[k], b[k], v);
        acc[m] = v;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int m = 0; m < kMaxPairs; ++m) {
    const int e = tid + m * kThreads;
    if (e < ntri) part[((size_t)p * nblk + blk) * ntri + e] = acc[m];
  }
}

// G[p] = mirror(sum over strips of part[p]); zero for inactive factors.
__global__ void sfm_gram_reduce(const int* __restrict__ active,
                                const float* __restrict__ part,
                                float* __restrict__ G, int R, int nblk) {
  const int p = blockIdx.x;
  const int ntri = R * (R + 1) / 2;
  const bool on = active[p] != 0;
  for (int e = threadIdx.x; e < ntri; e += blockDim.x) {
    float v = 0.0f;
    if (on) {
      for (int k = 0; k < nblk; ++k)
        v += part[((size_t)p * nblk + k) * ntri + e];
    }
    int i, j;
    tri_index(e, R, i, j);
    G[((size_t)p * R + i) * R + j] = v;
    G[((size_t)p * R + j) * R + i] = v;
  }
}

template <int GRAD_MODE, int LOSS, bool FROM_PROX>
cudaError_t launch(const float* params, const int* src, const int* dst,
                   const int* active, const float* codes, const float* img0,
                   const float* dpt, const float* jac, const float* img1,
                   const float* gx1, const float* gy1, float* part, int P,
                   int K, int K1, int CS, int H, int W, int px_per_blk,
                   int nblk, cudaStream_t st) {
  auto kern = sfm_gram_kernel<GRAD_MODE, LOSS, FROM_PROX>;
  const size_t smem = ((size_t)(CS + 8) * kStride + CS) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(nblk, P), kThreads, smem, st>>>(
      params, src, dst, active, codes, img0, dpt, jac, img1, gx1, gy1, part, K,
      K1, CS, H, W, px_per_blk, nblk);
  return cudaGetLastError();
}

template <int GRAD_MODE, int LOSS>
cudaError_t launch_prox(bool from_prox, const float* params, const int* src,
                        const int* dst, const int* active, const float* codes,
                        const float* img0, const float* dpt, const float* jac,
                        const float* img1, const float* gx1, const float* gy1,
                        float* part, int P, int K, int K1, int CS, int H,
                        int W, int px_per_blk, int nblk, cudaStream_t st) {
  if (from_prox)
    return launch<GRAD_MODE, LOSS, true>(params, src, dst, active, codes, img0,
                                         dpt, jac, img1, gx1, gy1, part, P, K,
                                         K1, CS, H, W, px_per_blk, nblk, st);
  return launch<GRAD_MODE, LOSS, false>(params, src, dst, active, codes, img0,
                                        dpt, jac, img1, gx1, gy1, part, P, K,
                                        K1, CS, H, W, px_per_blk, nblk, st);
}

}  // namespace

extern "C" int sfm_gram_launch(const float* params, const int* src,
                               const int* dst, const int* active,
                               const float* codes, const float* img0,
                               const float* dpt, const float* jac,
                               const float* img1, const float* gx1,
                               const float* gy1, float* part, float* G, int P,
                               int K, int K1, int CS, int H, int W,
                               int px_per_blk, int nblk, int grad_mode,
                               int loss, int from_prox, void* stream) {
  if (CS < 1 || CS > kMaxCS) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool fp = from_prox != 0;
  cudaError_t err;
  if (grad_mode == 0 && loss == 0)
    err = launch_prox<0, 0>(fp, params, src, dst, active, codes, img0, dpt,
                            jac, img1, gx1, gy1, part, P, K, K1, CS, H, W,
                            px_per_blk, nblk, st);
  else if (grad_mode == 0)
    err = launch_prox<0, 1>(fp, params, src, dst, active, codes, img0, dpt,
                            jac, img1, gx1, gy1, part, P, K, K1, CS, H, W,
                            px_per_blk, nblk, st);
  else if (loss == 0)
    err = launch_prox<1, 0>(fp, params, src, dst, active, codes, img0, dpt,
                            jac, img1, gx1, gy1, part, P, K, K1, CS, H, W,
                            px_per_blk, nblk, st);
  else
    err = launch_prox<1, 1>(fp, params, src, dst, active, codes, img0, dpt,
                            jac, img1, gx1, gy1, part, P, K, K1, CS, H, W,
                            px_per_blk, nblk, st);
  if (err != cudaSuccess) return (int)err;
  sfm_gram_reduce<<<P, 256, 0, st>>>(active, part, G, CS + 8, nblk);
  return (int)cudaGetLastError();
}

extern "C" const char* sfm_gram_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
