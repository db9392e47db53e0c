// A variant of csrc/sfm_error.cu's sfm_error_batch, timed by
// port_tools/sfm_error_variants.py and not part of the port: one thread
// block cluster of 1024-thread blocks per factor, reduced through
// distributed shared memory (no global partials, no ticket). Every factor is
// taken as active. Built with the port's nvcc flags beside a copy of
// csrc/sfm_common.cuh.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "sfm_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kBatch = 4;

__global__ void __launch_bounds__(kThreads, 1)
err_cluster_kernel(const float* __restrict__ params, const int* __restrict__ src,
                   const int* __restrict__ dst, const float* __restrict__ img0,
                   const float* __restrict__ dpt, const float* __restrict__ img1,
                   float* __restrict__ out, int K, int K1, int H, int W,
                   int px_per_blk) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ float ws[kWarps][2];
  __shared__ float2 mine;
  const int p = blockIdx.y;
  const int blk = blockIdx.x;
  const int tid = threadIdx.x;
  const int s = min(max(src[p], 0), K - 1);
  const int d = min(max(dst[p], 0), K1 - 1);
  const dfk::FactorParams f = dfk::load_params(params + p * dfk::kParamDim);
  const int N = H * W;
  const int begin = blk * px_per_blk;
  const int end = min(N, begin + px_per_blk);
  const float* im0 = img0 + (size_t)s * N;
  const float* dp0 = dpt + (size_t)s * N;
  const float* im1 = img1 + (size_t)d * N;
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
        const float e = dfk::robust_wv<0>(r, w.valid, f.huber) * r;
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
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum_r += __shfl_down_sync(0xffffffffu, sum_r, off);
    sum_v += __shfl_down_sync(0xffffffffu, sum_v, off);
  }
  if (lane == 0) {
    ws[warp][0] = sum_r;
    ws[warp][1] = sum_v;
  }
  __syncthreads();
  if (tid < 2) {
    float v = 0.0f;
    for (int k = 0; k < kWarps; ++k) v += ws[k][tid];
    if (tid == 0) mine.x = v; else mine.y = v;
  }
  cluster.sync();
  if (cluster.block_rank() == 0 && tid < 32) {
    const int nb = (int)cluster.num_blocks();
    float2 v = make_float2(0.0f, 0.0f);
    if (tid < nb) v = *cluster.map_shared_rank(&mine, tid);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      v.x += __shfl_down_sync(0xffffffffu, v.x, off);
      v.y += __shfl_down_sync(0xffffffffu, v.y, off);
    }
    if (tid == 0) {
      out[p * 2] = v.x;
      out[p * 2 + 1] = v.y;
    }
  }
  cluster.sync();
}

}  // namespace

extern "C" int err_cluster_launch(const float* params, const int* src,
                                  const int* dst, const float* img0,
                                  const float* dpt, const float* img1,
                                  float* out, int P, int K, int K1, int H,
                                  int W, int px_per_blk, int csize,
                                  void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      err_cluster_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(csize, P);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, err_cluster_kernel, params, src, dst, img0, dpt,
                         img1, out, K, K1, H, W, px_per_blk);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
