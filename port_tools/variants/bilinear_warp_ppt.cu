// A variant of csrc/dense_warp.cu's bilinear_warp_planes, kept to be timed
// beside the port's kernel by port_tools/bilinear_warp_variants.py and not
// part of the port: 1, 2 or 4 consecutive pixels a thread (px_per_blk =
// 256 times that), the coordinates read as one float, float2 or float4
// where aligned, the outputs stored the same way. Otherwise the port's
// design: planes by pointer and element stride, C = 1..4 at compile time,
// all 4 * C * PPT gathers of a thread before its first store, a
// programmatic dependent launch. One pixel a thread was fastest at the three
// pyramid sizes on an H100, so the port keeps only that. Same C interface
// as the port's bilinear_warp_launch. Built with the port's nvcc flags and
// -I deepfactors_tpu_torch/csrc.
#include <cuda_runtime.h>

#include <cstdint>

#include "sfm_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPlanes = 8;

struct Planes {
  const float* ptr[kMaxPlanes];
  int stride[kMaxPlanes];   // elements between two consecutive pixels
};

// PPT consecutive values at v + n: one vector load where the whole run lies
// inside [0, N) and v + n is aligned to it, else one load a pixel (pixels
// past N read 0 and are never stored).
template <int PPT>
__device__ __forceinline__ void load_run(const float* __restrict__ v, int n,
                                         int N, bool vec, float (&r)[PPT]) {
  if constexpr (PPT == 4) {
    if (vec) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(v + n));
      r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
      return;
    }
  } else if constexpr (PPT == 2) {
    if (vec) {
      const float2 a = __ldg(reinterpret_cast<const float2*>(v + n));
      r[0] = a.x; r[1] = a.y;
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < PPT; ++j) r[j] = (n + j < N) ? __ldg(v + n + j) : 0.0f;
}

template <int PPT>
__device__ __forceinline__ void store_run(float* __restrict__ o, int n, int N,
                                          bool vec, const float (&r)[PPT]) {
  if constexpr (PPT == 4) {
    if (vec) {
      *reinterpret_cast<float4*>(o + n) = make_float4(r[0], r[1], r[2], r[3]);
      return;
    }
  } else if constexpr (PPT == 2) {
    if (vec) {
      *reinterpret_cast<float2*>(o + n) = make_float2(r[0], r[1]);
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < PPT; ++j)
    if (n + j < N) o[n + j] = r[j];
}

// the four corner values of one plane at one pixel's corners
__device__ __forceinline__ void gather4(const float* __restrict__ plane,
                                        int stride, const dfk::Corners& c,
                                        float (&v)[4]) {
  v[0] = __ldg(plane + (size_t)c.i00 * stride);
  v[1] = __ldg(plane + (size_t)c.i01 * stride);
  v[2] = __ldg(plane + (size_t)c.i10 * stride);
  v[3] = __ldg(plane + (size_t)c.i11 * stride);
}

// dfk::interp_value's blend, in its op order
__device__ __forceinline__ float blend(const float (&v)[4],
                                       const dfk::Corners& c) {
  const float top = v[0] + c.wx * (v[1] - v[0]);
  const float bot = v[2] + c.wx * (v[3] - v[2]);
  return top + c.wy * (bot - top);
}

// out [nplanes, H, W]. C > 0: nplanes == C, known at compile time; C == 0:
// the general loop over nplanes (<= kMaxPlanes).
template <int C, int PPT>
__global__ void __launch_bounds__(kThreads)
bilinear_warp_kernel(const Planes planes, const float* __restrict__ x1,
                     const float* __restrict__ y1, float* __restrict__ out,
                     int nplanes, int H, int W, int px_per_blk) {
  // launched as a programmatic dependent launch: nothing of the kernel
  // before this one on the stream is visible until this returns
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int N = H * W;
  const int n = blockIdx.x * px_per_blk + threadIdx.x * PPT;
  if (n >= N) return;
  const bool full = n + PPT <= N;
  const bool vec_in = full &&
      ((reinterpret_cast<uintptr_t>(x1) | reinterpret_cast<uintptr_t>(y1)) %
       (4 * PPT)) == 0;
  // out is the wrapper's allocation: plane k starts at k * N floats
  const bool vec_out = full && N % PPT == 0;
  float xs[PPT], ys[PPT];
  load_run<PPT>(x1, n, N, vec_in, xs);
  load_run<PPT>(y1, n, N, vec_in, ys);
  dfk::Corners c[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) c[j] = dfk::corners(xs[j], ys[j], H, W);

  if constexpr (C > 0) {
    float v[C][PPT][4];
#pragma unroll
    for (int k = 0; k < C; ++k)
#pragma unroll
      for (int j = 0; j < PPT; ++j)
        gather4(planes.ptr[k], planes.stride[k], c[j], v[k][j]);
#pragma unroll
    for (int k = 0; k < C; ++k) {
      float r[PPT];
#pragma unroll
      for (int j = 0; j < PPT; ++j) r[j] = blend(v[k][j], c[j]);
      store_run<PPT>(out + (size_t)k * N, n, N, vec_out, r);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kMaxPlanes; ++k) {
      if (k >= nplanes) break;
      float v[PPT][4];
#pragma unroll
      for (int j = 0; j < PPT; ++j)
        gather4(planes.ptr[k], planes.stride[k], c[j], v[j]);
      float r[PPT];
#pragma unroll
      for (int j = 0; j < PPT; ++j) r[j] = blend(v[j], c[j]);
      store_run<PPT>(out + (size_t)k * N, n, N, vec_out, r);
    }
  }
}

// A programmatic dependent launch: the grid may start while the kernel
// before it on the stream (the PyTorch op that wrote x1, y1) drains; the
// kernel waits for it with griddepcontrol.wait before touching memory.
template <typename... KArgs, typename... Args>
cudaError_t launch_on(void (*kern)(KArgs...), int nblk, cudaStream_t stream,
                      Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nblk);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, args...);
}

template <int PPT>
cudaError_t bilinear_warp_dispatch(const Planes& planes, const float* x1,
                                   const float* y1, float* out, int C, int H,
                                   int W, int px_per_blk, int nblk,
                                   cudaStream_t st) {
  switch (C) {
    case 1:
      return launch_on(bilinear_warp_kernel<1, PPT>, nblk, st, planes, x1, y1,
                       out, C, H, W, px_per_blk);
    case 2:
      return launch_on(bilinear_warp_kernel<2, PPT>, nblk, st, planes, x1, y1,
                       out, C, H, W, px_per_blk);
    case 3:
      return launch_on(bilinear_warp_kernel<3, PPT>, nblk, st, planes, x1, y1,
                       out, C, H, W, px_per_blk);
    case 4:
      return launch_on(bilinear_warp_kernel<4, PPT>, nblk, st, planes, x1, y1,
                       out, C, H, W, px_per_blk);
    default:
      return launch_on(bilinear_warp_kernel<0, PPT>, nblk, st, planes, x1, y1,
                       out, C, H, W, px_per_blk);
  }
}

}  // namespace

// planes / strides: host arrays of the C (1..kMaxPlanes) planes' device
// pointers and element strides; out [C, H, W]. px_per_blk (256 threads
// times 1, 2 or 4 pixels) and nblk come from the wrapper's launch plan.
extern "C" int bilinear_warp_launch(const void* const* planes,
                                    const int* strides, const float* x1,
                                    const float* y1, float* out, int C, int H,
                                    int W, int px_per_blk, int nblk,
                                    void* stream) {
  const int ppt = px_per_blk / kThreads;
  if (C < 1 || C > kMaxPlanes || px_per_blk % kThreads != 0 ||
      (ppt != 1 && ppt != 2 && ppt != 4) || nblk < 1)
    return (int)cudaErrorInvalidValue;
  Planes pl{};
  for (int k = 0; k < C; ++k) {
    pl.ptr[k] = static_cast<const float*>(planes[k]);
    pl.stride[k] = strides[k];
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (ppt == 1)
    err = bilinear_warp_dispatch<1>(pl, x1, y1, out, C, H, W, px_per_blk,
                                    nblk, st);
  else if (ppt == 2)
    err = bilinear_warp_dispatch<2>(pl, x1, y1, out, C, H, W, px_per_blk,
                                    nblk, st);
  else
    err = bilinear_warp_dispatch<4>(pl, x1, y1, out, C, H, W, px_per_blk,
                                    nblk, st);
  return (int)err;
}
