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

// ---- inclusive prefix sums in XLA's order -------------------------------
// The order in which XLA adds jnp.cumsum on the CPU
// (core/changepoint.py::xla_order_cumsum): serial adds inside blocks of 16
// with the tail zero-padded, the block totals scanned by the same rule
// recursively, each block's exclusive carry (+0 for block 0) added last.
// A block scans its row level by level in shared memory, one thread per
// 16-block; a level's arrays hold one pad word after every 16 values so
// those threads hit distinct banks.
constexpr int kScanBlock = 16;  // XLA's base for the blocked cumsum
constexpr int kScanPad = kScanBlock + 1;  // one pad word per 16 values
constexpr int kMaxLevels = 8;  // 16^8 > any int32 row length

__device__ __forceinline__ int padded(int i) { return i + (i >> 4); }

// Level geometry of one row: level 0 scans the row's n values, level l+1
// the nb[l] block totals of level l, up to the first level of one block.
struct Levels {
  int count;
  int len[kMaxLevels];  // values scanned at this level
  int nb[kMaxLevels];  // its 16-blocks
  int off[kMaxLevels];  // float offset of its three channels
};

__device__ __forceinline__ Levels levels_of(int n) {
  Levels lv;
  lv.count = 0;
  int m = n, off = 0;
  while (true) {
    const int nb = (m + kScanBlock - 1) / kScanBlock;
    lv.len[lv.count] = m;
    lv.nb[lv.count] = nb;
    lv.off[lv.count] = off;
    off += 3 * kScanPad * nb;
    ++lv.count;
    if (nb == 1) break;
    m = nb;
  }
  return lv;
}

// The three channels (0: z, 1: z*z, 2: k*z) of level l.
struct Chans {
  float* c[3];
};

__device__ __forceinline__ Chans chans(float* buf, const Levels& lv, int l) {
  Chans ch;
  for (int c = 0; c < 3; ++c)
    ch.c[c] = buf + lv.off[l] + c * kScanPad * lv.nb[l];
  return ch;
}

// The prefix sums of z, z*z and k*z (k = i + 1) over one row, in place.
// On entry chans(buf, lv, 0).c[0][padded(i)] holds z for i < nb[0] * 16
// (zeros past the row), and the block is synced; on exit every level is
// scanned and carried except level 0, whose carry prefix3 adds as it
// reads, and the block is synced.  Every thread of the block calls it.
__device__ __forceinline__ void xla_scan3(float* buf, const Levels& lv,
                                          int tid, int nt) {
  const Chans s0 = chans(buf, lv, 0);
  // level 0: serial adds inside each 16-block, z in place.
  for (int b = tid; b < lv.nb[0]; b += nt) {
    float a[3];
#pragma unroll
    for (int j = 0; j < kScanBlock; ++j) {
      const int i = b * kScanBlock + j, p = padded(i);
      const float z = s0.c[0][p];
      const float v[3] = {z, rn_mul(z, z),
                          rn_mul(static_cast<float>(i + 1), z)};
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        a[c] = j == 0 ? v[c] : rn_add(a[c], v[c]);
        s0.c[c][p] = a[c];
      }
    }
  }
  __syncthreads();

  // upper levels: serial adds over the block totals below.
  for (int l = 1; l < lv.count; ++l) {
    const Chans below = chans(buf, lv, l - 1), here = chans(buf, lv, l);
    const int len = lv.len[l];
    for (int b = tid; b < lv.nb[l]; b += nt) {
      float a[3];
#pragma unroll
      for (int j = 0; j < kScanBlock; ++j) {
        const int i = b * kScanBlock + j;
        const int src = padded(i * kScanBlock + kScanBlock - 1);
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float v = i < len ? below.c[c][src] : 0.0f;
          a[c] = j == 0 ? v : rn_add(a[c], v);
          here.c[c][padded(i)] = a[c];
        }
      }
    }
    __syncthreads();
  }

  // carries, top down: every level of more than one block adds the
  // exclusive prefix of its block totals (+0 for block 0) last.
  for (int l = lv.count - 2; l >= 1; --l) {
    const Chans here = chans(buf, lv, l), above = chans(buf, lv, l + 1);
    for (int i = tid; i < lv.len[l]; i += nt) {
      const int b = i / kScanBlock;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float carry = b > 0 ? above.c[c][padded(b - 1)] : 0.0f;
        here.c[c][padded(i)] = rn_add(here.c[c][padded(i)], carry);
      }
    }
    __syncthreads();
  }
}

// Where xla_scan3 left a row's scans: level 0 and, when the row has more
// than one 16-block, level 1, whose values are level 0's carries.
struct ScanView {
  Chans s0, s1;
  bool carried;
};

__device__ __forceinline__ ScanView scan_view(float* buf, const Levels& lv) {
  ScanView v;
  v.s0 = chans(buf, lv, 0);
  v.carried = lv.count > 1;
  v.s1 = v.carried ? chans(buf, lv, 1) : v.s0;
  return v;
}

// The three inclusive prefix sums at position i, level 0's carry added.
__device__ __forceinline__ void prefix3(const ScanView& v, int i,
                                        float cs[3]) {
  const int p = padded(i), b = i / kScanBlock;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    cs[c] = v.s0.c[c][p];
    if (v.carried)
      cs[c] = rn_add(cs[c], b > 0 ? v.s1.c[c][padded(b - 1)] : 0.0f);
  }
}

}  // namespace repro_torch
