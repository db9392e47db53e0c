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
// Design (one launch, fp32 FMA pipe, register-tiled):
//  - One block of 256 threads per (factor, pixel strip), two blocks resident
//    on an SM; blocks of one strip of all factors are neighbours in the
//    grid, so factors that share a source keyframe read its planes out of
//    L2 at about the same time. The strip is walked in tiles of up to 256
//    pixels.
//  - The tile's input planes (CS rows of jac^T, the proximity or depth row,
//    the source image row) are copied into a shared-memory stage by the
//    bulk-copy (TMA) unit, one copy per row started by lane 0 of the warps,
//    completing on an mbarrier; the copy for the next tile runs while this
//    tile is accumulated. Planes that are not 16-byte aligned (H*W no
//    multiple of 4) fall back to 4-byte cp.async by every thread.
//  - Build: every thread turns its pixel's stage column into the row b, in
//    shared memory, pixel-major: row q of pixel t at rows[t * stride + q],
//    stride = Rp + 4 floats with Rp = R rounded up to 8. The stride is an
//    odd number of 16-byte words, so the eight lanes of a quarter warp store
//    their float4s to eight different bank groups. The row is kept as
//    [jac(CS) | A(6) | w*r | valid | 0...] so that the jac part starts
//    16-byte aligned; the writer of G maps back to the public order.
//  - Accumulate: the upper triangle of the Rp x Rp Gram is cut into 8 x 8
//    register tiles (15 at CS = 32). A thread owns one tile and one slice
//    of the tile's pixels: thread = slice * lanes + tile with ``lanes`` the
//    tile count rounded up (16 at CS = 32), so the lanes of a warp that sit
//    at the same pixel read the same 16-byte words. Per pixel a thread
//    does 4 float4 loads for 64 fmaf, against 2 scalar loads per fmaf in
//    the first design of this kernel. Diagonal tiles are computed whole;
//    only their j >= i entries are written.
//  - At the end of the strip the slices' accumulators are summed in slice
//    order through shared memory (two rounds of 32 accumulators) and the
//    block writes one partial per strip. The last block of a factor to
//    finish (an integer ticket per factor: __threadfence, atomicAdd on an
//    int) sums the strips' partials in strip order, mirrors, writes G in the
//    public row order and resets the ticket. No float atomics and every sum
//    in a fixed order: the result is bitwise reproducible. The ticket
//    buffer belongs to the wrapper, one per stream; calls on one stream are
//    ordered, so a ticket is always 0 when a launch starts.
//  - Inactive factors skip all work; their block 0 writes G = 0. A null
//    active takes every factor as active.
//  - The geometry has one owner: launch_plan in ops/kernels/sfm_gram.py
//    hands over the tile table (tile -> block row and column, shared-memory
//    row -> row of G), lanes, slices, steps, the row stride and the stage
//    offset; the kernel derives none of them and the launcher only holds
//    them against the block size and the shared memory asked for.
//  - fp32 throughout, no tensor cores: the per-pixel math rounds op by op
//    (built with --fmad=false, like the plain PyTorch twin) and the Gram
//    accumulation uses explicit fmaf(). CS is a run-time argument up to 64.
//
// What bounds it as built: the schedulers' instruction rate. A tile of 256
// pixels costs about 2,400 scheduler cycles of accumulation (960 fmaf a
// pixel: 15 whole tiles for the 820 of the triangle, plus the loads) and
// about 1,500 of row building (eight IEEE divisions and a square root a pixel, two passes
// over the jac column), on one SM; both run on the same four schedulers.
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W limit, P = 128 with 64
// active, CS 32, depth from the codes: 286 / 85 / 30 us at 192x256 / 96x128
// / 48x64 against bounds of 78 / 19 / 4.5 us (the first design of this
// kernel, two launches: 937 / 253 / 88 us); 128 registers, no spills in six
// of the eight instances. The split and what was tried: PERF.md section 6.
#include <cuda_runtime.h>

#include <atomic>

#include "sfm_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStage = kThreads;               // floats of one stage row
constexpr int kTile = 8;                       // register tile edge
constexpr int kAcc = kTile * kTile;            // accumulators per thread
constexpr int kRound = 32;                     // accumulators per reduce round
constexpr int kMaxCS = 64;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ void store4(float* p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// --- asynchronous copies into shared memory -------------------------------
// Aligned planes: one bulk copy (TMA unit) per row of the stage, completing
// on an mbarrier. Otherwise: 4-byte cp.async by every thread of the block.
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void cp_async4(float* smem, const float* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(smem)),
               "l"(g));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

template <int GRAD_MODE, int LOSS, bool FROM_PROX>
__global__ void __launch_bounds__(kThreads, 2)
sfm_gram_kernel(const float* __restrict__ params, const int* __restrict__ src,
                const int* __restrict__ dst, const int* __restrict__ active,
                const float* __restrict__ codes,
                const float* __restrict__ img0, const float* __restrict__ dpt,
                const float* __restrict__ jac, const float* __restrict__ img1,
                const float* __restrict__ gx1, const float* __restrict__ gy1,
                float* part, float* __restrict__ G, int* tickets, int K,
                int K1, int CS, int H, int W, int px_per_blk, int nblk,
                const int* __restrict__ table, int Rp, int ntiles, int lanes,
                int nslices, int steps, int stride, int stage_off) {
  extern __shared__ __align__(16) float sh[];
  __shared__ float code_sh[kMaxCS];
  __shared__ int is_last;
  __shared__ __align__(8) unsigned long long stage_bar;
  const int p = blockIdx.x;
  const int blk = blockIdx.y;
  const int tid = threadIdx.x;
  const int R = CS + 8;
  if (active && active[p] == 0) {
    if (blk == 0) {
      float* g = G + (size_t)p * R * R;
      for (int e = tid; e < R * R; e += kThreads) g[e] = 0.0f;
    }
    return;
  }
  const int N = H * W;
  const int tile_px = nslices * steps;
  constexpr int ts = kStage;
  float* rows = sh;                             // [tile_px][stride]
  float* stage = sh + stage_off;                // [CS + 2][ts]
  unsigned long long* bar = &stage_bar;
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
  if (tid == 0) mbar_init(bar);
  // the padding rows [R, Rp) of every pixel are zero for the whole strip
  if (tid < tile_px) {
    for (int q = R; q < Rp; ++q) rows[tid * stride + q] = 0.0f;
  }
  __syncthreads();

  // the plan's table: tile t -> block row, tile t -> block column of the
  // upper triangle, then shared-memory row q -> row of G (-1: padding)
  const int my_tile = tid % lanes;
  const int my_slice = tid / lanes;
  const bool works = my_tile < ntiles && my_slice < nslices;
  const int oa = works ? kTile * __ldg(table + my_tile) : 0;
  const int ob = works ? kTile * __ldg(table + ntiles + my_tile) : 0;
  float acc[kAcc];
#pragma unroll
  for (int e = 0; e < kAcc; ++e) acc[e] = 0.0f;

  const bool vec = (CS & 3) == 0;
  const int CS4 = CS & ~3;
  const int begin = blk * px_per_blk;
  const int end = min(N, begin + px_per_blk);
  const bool wide = ((N | px_per_blk | tile_px) & 3) == 0 &&
      ((reinterpret_cast<size_t>(jc0) | reinterpret_cast<size_t>(dp0) |
        reinterpret_cast<size_t>(im0)) & 15) == 0;
  auto prefetch = [&](int tile) {
    const int npx = min(tile_px, end - tile);
    if (wide) {
      const unsigned bytes = (unsigned)npx * 4u;
      if (tid == 0) mbar_expect(bar, (unsigned)(CS + 2) * bytes);
      if ((tid & 31) == 0) {
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        for (int c = tid >> 5; c < CS + 2; c += kThreads / 32) {
          const float* g = (c < CS ? jc0 + (size_t)c * N : (c == CS ? dp0 : im0));
          bulk_copy(stage + c * ts, g + tile, bytes, bar);
        }
      }
    } else {
      const int total = (CS + 2) * npx;
      for (int i = tid; i < total; i += kThreads) {
        const int c = i / npx;
        const int x = i - c * npx;
        const float* g = (c < CS ? jc0 + (size_t)c * N : (c == CS ? dp0 : im0));
        cp_async4(stage + c * ts + x, g + tile + x);
      }
      cp_async_commit();
    }
  };
  unsigned parity = 0;
  int px = (begin + tid) % W, py = (begin + tid) / W;
  prefetch(begin);
  for (int tile = begin; tile < end; tile += tile_px) {
    // ---- build: one pixel's row per thread, from the staged planes ------
    if (wide) {
      mbar_wait(bar, parity);
      parity ^= 1;
    } else {
      cp_async_wait_all();
    }
    __syncthreads();      // the stage is complete, the rows were consumed
    const int n = tile + tid;
    float* row = rows + tid * stride;
    if (tid < tile_px && n < end) {
      const float xs = (float)px;
      const float ys = (float)py;
      const float* st = stage + tid;
      float depth;
      if (FROM_PROX) {
        float prx = st[CS * ts];
        int c = 0;
        for (; c + 8 <= CS; c += 8) {
          float m[8];
#pragma unroll
          for (int q = 0; q < 8; ++q) m[q] = code_sh[c + q] * st[(c + q) * ts];
#pragma unroll
          for (int q = 0; q < 8; ++q) prx = prx + m[q];
        }
        for (; c < CS; ++c) prx = prx + code_sh[c] * st[c * ts];
        prx = fmaxf(prx, 1e-4f);
        depth = f.avg_dpt / prx - f.avg_dpt;
      } else {
        depth = st[CS * ts];
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
      const float r = st[(CS + 1) * ts] - i1;
      const float wv = dfk::robust_wv<LOSS>(r, w.valid, f.huber);
      const float sc = wv * err_J_prx;
      int c = 0;
      for (; c + 8 <= CS; c += 8) {
        float m[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) m[q] = sc * st[(c + q) * ts];
        store4(row + c, m[0], m[1], m[2], m[3]);
        store4(row + c + 4, m[4], m[5], m[6], m[7]);
      }
      for (; c < CS4; c += 4)
        store4(row + c, sc * st[c * ts], sc * st[(c + 1) * ts],
               sc * st[(c + 2) * ts], sc * st[(c + 3) * ts]);
      for (; c < CS; ++c) row[c] = sc * st[c * ts];
      const float wr = wv * r;
      const float ok = w.valid ? 1.0f : 0.0f;
      if (vec) {
        store4(row + CS, wv * A[0], wv * A[1], wv * A[2], wv * A[3]);
        store4(row + CS + 4, wv * A[4], wv * A[5], wr, ok);
      } else {
#pragma unroll
        for (int q = 0; q < 6; ++q) row[CS + q] = wv * A[q];
        row[CS + 6] = wr;
        row[CS + 7] = ok;
      }
    } else if (tid < tile_px) {
      for (int q = 0; q < Rp; q += 4) store4(row + q, 0.0f, 0.0f, 0.0f, 0.0f);
    }
    px += tile_px;
    while (px >= W) {
      px -= W;
      ++py;
    }
    __syncthreads();      // the rows are complete, the stage was read
    // ---- accumulate: one 8 x 8 tile over this thread's pixel slice, while
    // the next tile's planes arrive
    if (tile + tile_px < end) prefetch(tile + tile_px);
    if (works) {
      const float* base = rows + my_slice * stride;
      const int hop = nslices * stride;
#pragma unroll 2
      for (int q = 0; q < steps; ++q, base += hop) {
        const float4 a0 = *reinterpret_cast<const float4*>(base + oa);
        const float4 a1 = *reinterpret_cast<const float4*>(base + oa + 4);
        const float4 b0 = *reinterpret_cast<const float4*>(base + ob);
        const float4 b1 = *reinterpret_cast<const float4*>(base + ob + 4);
        const float a[kTile] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float b[kTile] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < kTile; ++i) {
#pragma unroll
          for (int jj = 0; jj < kTile; ++jj)
            acc[i * kTile + jj] = fmaf(a[i], b[jj], acc[i * kTile + jj]);
        }
      }
    }
  }
  __syncthreads();

  // ---- the block's partial: slices summed in slice order ---------------
  // part[p][blk][e * ntiles + tile], e = accumulator index in the tile
  const int part_len = ntiles * kAcc;
  float* out = part + ((size_t)p * nblk + blk) * part_len;
  float* red = sh;                              // [kRound][kThreads]
#pragma unroll
  for (int h = 0; h < kAcc / kRound; ++h) {
#pragma unroll
    for (int e = 0; e < kRound; ++e)
      red[e * kThreads + tid] = acc[h * kRound + e];
    __syncthreads();
    for (int o = tid; o < ntiles * kRound; o += kThreads) {
      const float* col = red + (o / ntiles) * kThreads + (o % ntiles);
      float v = 0.0f;
      for (int q = 0; q < nslices; ++q) v += col[q * lanes];
      out[h * kRound * ntiles + o] = v;
    }
    __syncthreads();
  }

  // ---- ticket: the last block of the factor writes G --------------------
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(tickets + p, 1) == nblk - 1;
  __syncthreads();
  if (!is_last) return;
  if (tid == 0) tickets[p] = 0;
  __threadfence();
  const float* all = part + (size_t)p * nblk * part_len;
  float* g = G + (size_t)p * R * R;
  for (int o = tid; o < part_len; o += kThreads) {
    float v = 0.0f;
    int q = 0;
    for (; q + 4 <= nblk; q += 4) {
      const float* a = all + (size_t)q * part_len + o;
      const float v0 = __ldcg(a), v1 = __ldcg(a + part_len);
      const float v2 = __ldcg(a + 2 * part_len), v3 = __ldcg(a + 3 * part_len);
      v += v0;
      v += v1;
      v += v2;
      v += v3;
    }
    for (; q < nblk; ++q) v += __ldcg(all + (size_t)q * part_len + o);
    const int e = o / ntiles;
    const int t = o % ntiles;
    const int ti = __ldg(table + t), tj = __ldg(table + ntiles + t);
    const int qi = kTile * ti + e / kTile;
    const int qj = kTile * tj + e % kTile;
    if (ti == tj && qj < qi) continue;
    const int gi = __ldg(table + 2 * ntiles + qi);
    const int gj = __ldg(table + 2 * ntiles + qj);
    if (gi < 0 || gj < 0) continue;
    g[gi * R + gj] = v;
    if (gi != gj) g[gj * R + gi] = v;
  }
}

template <int GRAD_MODE, int LOSS, bool FROM_PROX>
cudaError_t launch(const float* params, const int* src, const int* dst,
                   const int* active, const float* codes, const float* img0,
                   const float* dpt, const float* jac, const float* img1,
                   const float* gx1, const float* gy1, float* part, float* G,
                   int* tickets, int P, int K, int K1, int CS, int H, int W,
                   int px_per_blk, int nblk, const int* table, int Rp,
                   int ntiles, int lanes, int nslices, int steps, int stride,
                   int stage_off, int smem, cudaStream_t st) {
  auto kern = sfm_gram_kernel<GRAD_MODE, LOSS, FROM_PROX>;
  // the opt-in to more than 48 KB of shared memory, once per instance and
  // device (raised if a later call needs more)
  static std::atomic<int> configured[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem > configured[dev].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    configured[dev].store(smem, std::memory_order_relaxed);
  }
  kern<<<dim3(P, nblk), kThreads, smem, st>>>(
      params, src, dst, active, codes, img0, dpt, jac, img1, gx1, gy1, part, G,
      tickets, K, K1, CS, H, W, px_per_blk, nblk, table, Rp, ntiles, lanes,
      nslices, steps, stride, stage_off);
  return cudaGetLastError();
}

template <int GRAD_MODE, int LOSS, typename... Args>
cudaError_t launch_prox(bool from_prox, Args... args) {
  if (from_prox) return launch<GRAD_MODE, LOSS, true>(args...);
  return launch<GRAD_MODE, LOSS, false>(args...);
}

}  // namespace

// The geometry (tile table, lanes, slices, steps, row stride, stage offset,
// shared bytes) is the caller's: ops/kernels/sfm_gram.py::launch_plan owns
// it. Here it is only held against what the kernel's block size, shared
// memory and vector accesses can take.
extern "C" int sfm_gram_launch(const float* params, const int* src,
                               const int* dst, const int* active,
                               const float* codes, const float* img0,
                               const float* dpt, const float* jac,
                               const float* img1, const float* gx1,
                               const float* gy1, float* part, float* G,
                               int* tickets, const int* table, int P, int K,
                               int K1, int CS, int H, int W, int px_per_blk,
                               int nblk, int Rp, int ntiles, int lanes,
                               int nslices, int steps, int stride,
                               int stage_off, int smem, int grad_mode,
                               int loss, int from_prox, void* stream) {
  if (CS < 1 || CS > kMaxCS) return (int)cudaErrorInvalidValue;
  const int tile_px = nslices * steps;
  if (ntiles < 1 || Rp < CS + 8 || (Rp % kTile) != 0 || lanes < ntiles || nslices < 1 || steps < 1 ||
      nslices * lanes > kThreads || tile_px > kThreads || stride < Rp ||
      (stride & 3) != 0 || (stage_off & 3) != 0 ||
      stage_off < tile_px * stride || stage_off < kRound * kThreads ||
      smem < (stage_off + (CS + 2) * kStage) * (int)sizeof(float) ||
      px_per_blk < 1 || nblk > 65535 ||
      (long long)nblk * px_per_blk < (long long)H * W)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool fp = from_prox != 0;
#define SFM_GRAM_ARGS                                                        \
  fp, params, src, dst, active, codes, img0, dpt, jac, img1, gx1, gy1, part, \
      G, tickets, P, K, K1, CS, H, W, px_per_blk, nblk, table, Rp, ntiles,   \
      lanes, nslices, steps, stride, stage_off, smem, st
  if (grad_mode == 0 && loss == 0) return (int)launch_prox<0, 0>(SFM_GRAM_ARGS);
  if (grad_mode == 0) return (int)launch_prox<0, 1>(SFM_GRAM_ARGS);
  if (loss == 0) return (int)launch_prox<1, 0>(SFM_GRAM_ARGS);
  return (int)launch_prox<1, 1>(SFM_GRAM_ARGS);
#undef SFM_GRAM_ARGS
}

extern "C" const char* sfm_gram_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
