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
// Design of dense_warp_batch: one thread per output pixel, blocks of 256
// consecutive pixels of one factor, so every plane is read and written
// coalesced; the four corner taps of the three target planes hit L1/L2
// (neighbouring pixels warp to neighbouring corners). No reduction, no
// shared memory beyond the factor's params row. bilinear_warp_planes: its
// own section below. fp32 throughout, built with --fmad=false so every
// expression rounds op by op like the plain PyTorch twin.
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

// ---------------------------------------------------------------------------
// bilinear_warp_planes
//
// Planes are read in place: a pointer and an element stride a plane, so the
// caller's img1 [H, W] (stride 1) and the two channels of an interleaved
// Sobel gradient [H, W, 2] (stride 2, offsets 0 and 1) go in as they are,
// with no stacked copy. The pointers travel in the launch's parameters
// (Planes, passed by value), so a call copies nothing to the device.
//
// The work above an empty launch is one dependent chain a thread: load the
// coordinates, compute the corners, gather, blend, store. With C known at
// compile time (1..4) a thread issues all of its 4 * C gathers, and only
// then blends and stores: two round trips to memory before the first store
// instead of 1 + C. Above 4 planes one general loop samples plane after
// plane. One pixel a thread; the grid comes from
// sfm_gram.launch_plan("bilinear_warp_planes", ...). Bound: bytes (C + 2
// planes read, C written), far below the cost of the launch itself at the
// main path's sizes, so the launch is Hopper's programmatic dependent launch
// (launch_on below): it overlaps the tail of the op that wrote the
// coordinates.
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W limit, C = 3, in turns in
// one call (port_tools/bilinear_warp_variants.py): with a plain launch 2.66
// / 2.37 / 2.29 us at 192x256 / 96x128 / 48x64 against the first design's
// 2.80 / 2.71 / 2.63 (an empty launch 1.70 us); 2 and 4 pixels a thread
// (port_tools/variants/bilinear_warp_ppt.cu) were slower at every size.
// After the two PyTorch ops that write the coordinates (4.11 us alone), the
// stage took 5.78-5.81 us with the dependent launch, 6.71-6.72 with a plain
// one, and 10.12-10.23 in the first design (its caller's stack included).
// ---------------------------------------------------------------------------
constexpr int kMaxPlanes = 8;

struct Planes {
  const float* ptr[kMaxPlanes];
  int stride[kMaxPlanes];   // elements between two consecutive pixels
};

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
template <int C>
__global__ void __launch_bounds__(kThreads)
bilinear_warp_kernel(const Planes planes, const float* __restrict__ x1,
                     const float* __restrict__ y1, float* __restrict__ out,
                     int nplanes, int H, int W, int px_per_blk) {
  // launched as a programmatic dependent launch: nothing of the kernel
  // before this one on the stream is visible until this returns
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int N = H * W;
  const int n = blockIdx.x * px_per_blk + threadIdx.x;
  if (n >= N) return;
  const dfk::Corners c = dfk::corners(__ldg(x1 + n), __ldg(y1 + n), H, W);

  if constexpr (C > 0) {
    float v[C][4];
#pragma unroll
    for (int k = 0; k < C; ++k)
      gather4(planes.ptr[k], planes.stride[k], c, v[k]);
#pragma unroll
    for (int k = 0; k < C; ++k) out[(size_t)k * N + n] = blend(v[k], c);
  } else {
#pragma unroll
    for (int k = 0; k < kMaxPlanes; ++k) {
      if (k >= nplanes) break;
      float v[4];
      gather4(planes.ptr[k], planes.stride[k], c, v);
      out[(size_t)k * N + n] = blend(v, c);
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

// planes / strides: host arrays of the C (1..kMaxPlanes) planes' device
// pointers and element strides; out [C, H, W]. px_per_blk (256: one pixel
// a thread) and nblk come from the wrapper's launch plan.
extern "C" int bilinear_warp_launch(const void* const* planes,
                                    const int* strides, const float* x1,
                                    const float* y1, float* out, int C, int H,
                                    int W, int px_per_blk, int nblk,
                                    void* stream) {
  if (C < 1 || C > kMaxPlanes || px_per_blk != kThreads || nblk < 1)
    return (int)cudaErrorInvalidValue;
  Planes pl{};
  for (int k = 0; k < C; ++k) {
    pl.ptr[k] = static_cast<const float*>(planes[k]);
    pl.stride[k] = strides[k];
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1:
      return (int)launch_on(bilinear_warp_kernel<1>, nblk, st, pl, x1, y1,
                            out, C, H, W, px_per_blk);
    case 2:
      return (int)launch_on(bilinear_warp_kernel<2>, nblk, st, pl, x1, y1,
                            out, C, H, W, px_per_blk);
    case 3:
      return (int)launch_on(bilinear_warp_kernel<3>, nblk, st, pl, x1, y1,
                            out, C, H, W, px_per_blk);
    case 4:
      return (int)launch_on(bilinear_warp_kernel<4>, nblk, st, pl, x1, y1,
                            out, C, H, W, px_per_blk);
    default:
      return (int)launch_on(bilinear_warp_kernel<0>, nblk, st, pl, x1, y1,
                            out, C, H, W, px_per_blk);
  }
}

extern "C" const char* dense_warp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
