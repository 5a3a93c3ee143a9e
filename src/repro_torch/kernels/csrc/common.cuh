// Shared device helpers for the repro_torch kernels (sm_90a).
//
// Every elementwise step rounds as the plain PyTorch versions round: the
// arithmetic goes through the round-to-nearest intrinsics below, which the
// compiler never contracts into a multiply-add, so each one is one IEEE f32
// operation in the order written (a PyTorch op rounds once per op).  The
// library itself builds with nvcc's defaults, so math functions such as
// logf compile as they do inside PyTorch's own kernels.
#pragma once

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace repro_torch {

constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ float rn_add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float rn_sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float rn_mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float rn_div(float a, float b) { return __fdiv_rn(a, b); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// x rounded to TF32 (10-bit mantissa), nearest with ties away from zero, as
// cvt.rna.tf32.f32 rounds a finite x, in two integer operations: the
// magnitude sits below the sign bit, so adding half a unit carries into
// the kept bits away from zero.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}
// x = big + small, both TF32 (10-bit mantissas, nearest, ties away).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(__fsub_rn(x, __uint_as_float(big)));
}

// SSE of the best linear fit from raw segment sums; the same expression
// order as core.changepoint.segment_sse_terms.
__device__ __forceinline__ float seg_sse(float n1, float sx, float sy,
                                         float sxx, float sxy, float syy) {
  n1 = fmaxf(n1, 1.0f);
  const float sxx_c = rn_sub(sxx, rn_div(rn_mul(sx, sx), n1));
  const float sxy_c = rn_sub(sxy, rn_div(rn_mul(sx, sy), n1));
  const float syy_c = rn_sub(syy, rn_div(rn_mul(sy, sy), n1));
  const float sse =
      rn_sub(syy_c, sxx_c > 0.0f ? rn_div(rn_mul(sxy_c, sxy_c), sxx_c) : 0.0f);
  return fmaxf(sse, 0.0f);
}

// (value, index) argmin step: the smaller value wins, the lower index wins
// a tie (jnp.argmin / torch.argmin semantics).
__device__ __forceinline__ void argmin_merge(float& v, int& i, float ov,
                                             int oi) {
  if (ov < v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

// Block-wide argmin; blockDim.x must be a multiple of 32.  Every thread
// returns the block's winner.  Uses `sv`/`si` (>= 32 entries) as scratch.
__device__ __forceinline__ int block_argmin(float v, int i, float* sv,
                                            int* si) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int d = 16; d > 0; d >>= 1)
    argmin_merge(v, i, __shfl_down_sync(kFullMask, v, d),
                 __shfl_down_sync(kFullMask, i, d));
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < nw ? sv[lane] : inf_f();
    i = lane < nw ? si[lane] : INT_MAX;
    for (int d = 16; d > 0; d >>= 1)
      argmin_merge(v, i, __shfl_down_sync(kFullMask, v, d),
                   __shfl_down_sync(kFullMask, i, d));
    if (lane == 0) si[0] = i;
  }
  __syncthreads();
  const int best = si[0];
  __syncthreads();  // scratch free for the caller's next use
  return best;
}

}  // namespace repro_torch
