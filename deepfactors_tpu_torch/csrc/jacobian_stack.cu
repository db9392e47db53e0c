// The weighted Jacobian stack of the unfused photometric linearisation: per
// factor and keyframe pixel, the 12 + CS feature-major rows
// [dErr/dpose0 (6) | dErr/dpose1 (6) | dErr/dcode0 (CS)] of
// dense_sfm.sfm_step_batch, each times the pixel's robust weight, and the
// weighted residual, written out as whole planes for the Gram product that
// follows (a cuBLAS bmm, outside this kernel).
//
// Replaces no Pallas kernel. The JAX package leaves this build to one XLA
// fusion (deepfactors_tpu/ops/dense_sfm.py:322-392, the batched Jacobians
// before their matmul); the port built it eagerly, about a hundred PyTorch
// ops a chunk of factors that wrote a [P, 12 + CS, H * W] stack several
// times over (the stack, two pose products, the code rows, a cat, the
// weighted copy). This kernel is the counterpart of XLA's fusion: it reads
// dense_warp_batch's seven planes (i1, gx, gy, tptx, tpty, tptz, valid),
// depth, img0 and the code Jacobian jac0 [P, H, W, CS] as it lies, and
// writes Jw [P, 12 + CS, H * W] and rw [P, H * W] once.
//
// Rounding follows the eager chain op by op (the plain twin,
// ops/kernels/jacobian_stack.jacobian_stack_plain), so the stack is the
// eager one to the bit: every expression is written in the eager order and
// rounds per op (--fmad=false); the pose products j_pose^T A (K = 6) use
// fmaf from zero over k = 0..5, as the library's SIMT GEMM accumulates them;
// divisions by a scalar that PyTorch's CUDA kernels take as a product with
// the scalar's reciprocal are products here too (the wrapper hands the
// reciprocal). The weight multiplies every row without a select, so a row
// that is not finite where the weight is 0 is NaN, as in the eager chain.
//
// Bound on the H100: bytes. Per factor pixel the kernel reads 9 + CS fp32
// planes and writes 13 + CS: 4 (22 + 2 CS) bytes, 344 B at CS 32, against
// ~280 fp32 operations, about 0.8 flop/B, far below the card's ~20 flop/B.
// A chunk of 124 factors at 192x256 moves 2.10 GB: 0.63 ms at 3.35 TB/s.
//
// Design: one pixel a thread, blocks of 256 consecutive pixels of one
// factor, so every plane is read and every row written coalesced. jac0's
// [256 pixels, CS] tile is one contiguous span: it comes in with 16-byte
// loads into shared memory (rows of CS + 1 floats, CS even, so neither the
// scatter of the loads nor the column reads below conflict in a bank), and
// each thread then reads its pixel's CS values to write the CS code rows,
// each row stored coalesced across the warp. The per-pixel planes are
// loaded before the tile, so both are in flight together. No intermediate
// plane goes to device memory; fp32 throughout.
#include <cuda_runtime.h>

#include "sfm_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPoseRows = 12;
// the params row's entries the kernel reads: R (0-8), t (9-11), fx, fy
constexpr int kRowUsed = dfk::kFy + 1;

// dense_warp_batch's outputs, each [P, H, W]
struct WarpPlanes {
  const float* i1;
  const float* gx;
  const float* gy;
  const float* tptx;
  const float* tpty;
  const float* tptz;
  const float* valid;
};

// Jw [P, 12 + CS, N], rw [P, N]; jac0 [P, N, CS]; jp0, jp1 [P, 6, 6];
// u, v [N]; stride: floats between two pixels' rows of the tile; vec4:
// jac0's tile comes in as float4.
__global__ void __launch_bounds__(kThreads)
jacobian_stack_kernel(const float* __restrict__ params, const WarpPlanes wp,
                      const float* __restrict__ dpt0,
                      const float* __restrict__ img0,
                      const float* __restrict__ jac0,
                      const float* __restrict__ jp0,
                      const float* __restrict__ jp1,
                      const float* __restrict__ u_ray,
                      const float* __restrict__ v_ray, float* __restrict__ Jw,
                      float* __restrict__ rw, int N, int CS, int stride,
                      int vec4, int tukey, float delta, float inv_delta,
                      float avg) {
  extern __shared__ float tile[];   // [kThreads][stride]
  __shared__ float row[kRowUsed];
  __shared__ float j0[36], j1[36];
  const int p = blockIdx.y;
  const int n0 = blockIdx.x * kThreads;
  const int tid = threadIdx.x;
  const int n = n0 + tid;
  const int npx = min(kThreads, N - n0);
  const size_t base = (size_t)p * N;

  float i1 = 0.f, gx = 0.f, gy = 0.f, x = 0.f, y = 0.f, z = 0.f;
  float validf = 0.f, dpt = 0.f, im0 = 0.f, uu = 0.f, vv = 0.f;
  if (n < N) {
    i1 = __ldg(wp.i1 + base + n);
    gx = __ldg(wp.gx + base + n);
    gy = __ldg(wp.gy + base + n);
    x = __ldg(wp.tptx + base + n);
    y = __ldg(wp.tpty + base + n);
    z = __ldg(wp.tptz + base + n);
    validf = __ldg(wp.valid + base + n);
    dpt = __ldg(dpt0 + base + n);
    im0 = __ldg(img0 + base + n);
    uu = __ldg(u_ray + n);
    vv = __ldg(v_ray + n);
  }
  if (tid < kRowUsed) {
    row[tid] = params[p * dfk::kParamDim + tid];
  } else if (tid >= 32 && tid < 32 + 36) {
    j0[tid - 32] = jp0[p * 36 + tid - 32];
  } else if (tid >= 96 && tid < 96 + 36) {
    j1[tid - 96] = jp1[p * 36 + tid - 96];
  }
  const float* src = jac0 + (base + n0) * CS;
  const int count = npx * CS;
  if (vec4) {
    const float4* src4 = reinterpret_cast<const float4*>(src);
    for (int f = tid; f < count / 4; f += kThreads) {
      const float4 q = __ldg(src4 + f);
      const int px = (4 * f) / CS;
      float* d = tile + px * stride + (4 * f - px * CS);
      d[0] = q.x;
      d[1] = q.y;
      d[2] = q.z;
      d[3] = q.w;
    }
  } else {
    for (int e = tid; e < count; e += kThreads) {
      const int px = e / CS;
      tile[px * stride + (e - px * CS)] = __ldg(src + e);
    }
  }
  __syncthreads();
  if (n >= N) return;

  // geometry/warping's warp_jacobians, in its op order
  const float fx = row[dfk::kFx], fy = row[dfk::kFy];
  const float iz = 1.0f / z;
  const float d00 = fx * iz;
  const float d02 = -fx * x * iz * iz;
  const float d11 = fy * iz;
  const float d12 = -fy * y * iz * iz;
  const float gd0 = gx * d00;
  const float gd1 = gy * d11;
  const float gd2 = gx * d02 + gy * d12;
  const float vx = x - row[9];
  const float vy = y - row[10];
  const float vz = z - row[11];
  float A[6];
  A[0] = gd0;
  A[1] = gd1;
  A[2] = gd2;
  A[3] = -gd1 * vz + gd2 * vy;
  A[4] = gd0 * vz - gd2 * vx;
  A[5] = -gd0 * vy + gd1 * vx;
  const float m0 = row[0] * uu + row[1] * vv + row[2];
  const float m1 = row[3] * uu + row[4] * vv + row[5];
  const float m2 = row[6] * uu + row[7] * vv + row[8];
  const float pjd0 = d00 * m0 + d02 * m2;
  const float pjd1 = d11 * m1 + d12 * m2;
  // warping.depth_jacobian_prx: avg / t and -avg / t are PyTorch's
  // reciprocal(t) * avg and reciprocal(t) * -avg
  const float prx = (1.0f / (dpt + avg)) * avg;
  const float dpt_J_prx = (1.0f / (prx * prx)) * -avg;
  const float err_J_prx = -(gx * pjd0 + gy * pjd1) * dpt_J_prx;

  // the robust weight (m_estimators.huber_weight / tukey_sqrt_weight) and
  // the mask: wv = valid ? w : 0
  const float r = im0 - i1;
  float w;
  if (tukey) {
    const float a = r * inv_delta;   // r / c: PyTorch's r * (1 / c)
    const float t = 1.0f - a * a;
    w = t < 0.0f ? 0.0f : t;         // clamp(min=0), NaN kept
  } else {
    const float aa = fabsf(r);
    const float safe = aa < 1e-12f ? 1e-12f : aa;   // clamp, NaN kept
    const float out = sqrtf(delta * (2.0f * aa - delta)) / safe;
    w = aa <= delta ? 1.0f : out;
  }
  const float wv = validf > 0.5f ? w : 0.0f;

  // -(j_pose^T @ A), then every row times wv
  float* o = Jw + base * (kPoseRows + CS) + n;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      s0 = fmaf(j0[k * 6 + i], A[k], s0);
      s1 = fmaf(j1[k * 6 + i], A[k], s1);
    }
    o[(size_t)i * N] = -s0 * wv;
    o[(size_t)(6 + i) * N] = -s1 * wv;
  }
  const float* jac = tile + tid * stride;
  o += (size_t)kPoseRows * N;
  for (int k = 0; k < CS; ++k) o[(size_t)k * N] = err_J_prx * jac[k] * wv;
  rw[base + n] = r * wv;
}

}  // namespace

// The 17 pointers in the order of the kernel's arguments (params, the seven
// warp planes, dpt0, img0, jac0, jp0, jp1, u, v, Jw, rw). nblk (strips of
// kThreads pixels a factor), stride and smem_bytes come from the wrapper's
// launch plan (sfm_gram.launch_plan("jacobian_stack", ...)).
extern "C" int jacobian_stack_launch(
    const float* params, const float* i1, const float* gx, const float* gy,
    const float* tptx, const float* tpty, const float* tptz,
    const float* valid, const float* dpt0, const float* img0,
    const float* jac0, const float* jp0, const float* jp1, const float* u,
    const float* v, float* Jw, float* rw, int P, int N, int CS, int nblk,
    int px_per_blk, int stride, int smem_bytes, int vec4, int tukey,
    float delta, float inv_delta, float avg, void* stream) {
  if (px_per_blk != kThreads || nblk < 1 || P < 1 || CS < 1 ||
      stride < CS || (long long)nblk * kThreads < N ||
      smem_bytes < (int)(kThreads * stride * sizeof(float)))
    return (int)cudaErrorInvalidValue;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        jacobian_stack_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const WarpPlanes wp{i1, gx, gy, tptx, tpty, tptz, valid};
  jacobian_stack_kernel<<<dim3(nblk, P), kThreads, smem_bytes,
                          static_cast<cudaStream_t>(stream)>>>(
      params, wp, dpt0, img0, jac0, jp0, jp1, u, v, Jw, rw, N, CS, stride,
      vec4, tukey, delta, inv_delta, avg);
  return (int)cudaGetLastError();
}

extern "C" const char* jacobian_stack_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
