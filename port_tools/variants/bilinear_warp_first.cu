// The first design of csrc/dense_warp.cu's bilinear_warp_planes (commits
// 2183e17 to 8a9b388), kept to be timed beside the port's kernel and not part
// of the port: chip_smoke.py's in-context row of the sampling stage (the
// caller's torch.stack of the planes, then this kernel) and
// port_tools/bilinear_warp_variants.py. One thread a pixel; the planes are
// one contiguous [C, H, W] array; C at run time, so a thread gathers,
// blends and stores one plane after the other. Built with the port's nvcc
// flags and -I deepfactors_tpu_torch/csrc.
#include <cuda_runtime.h>

#include "sfm_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bilinear_warp_first_kernel(const float* __restrict__ chans,
                           const float* __restrict__ x1,
                           const float* __restrict__ y1,
                           float* __restrict__ out, int C, int H, int W) {
  const int N = H * W;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const dfk::Corners c = dfk::corners(__ldg(x1 + n), __ldg(y1 + n), H, W);
  for (int k = 0; k < C; ++k)
    out[(size_t)k * N + n] = dfk::interp_value(chans + (size_t)k * N, c);
}

}  // namespace

extern "C" int bilinear_warp_first_launch(const float* chans, const float* x1,
                                          const float* y1, float* out, int C,
                                          int H, int W, void* stream) {
  const int grid = (H * W + kThreads - 1) / kThreads;
  bilinear_warp_first_kernel<<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      chans, x1, y1, out, C, H, W);
  return (int)cudaGetLastError();
}
