// Fused window vet: the whole vet pipeline for every ragged window of one
// record arena in one launch, for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/windowvet/kernel.py::fused_window_vet_scan
// (the Pallas body _kernel with _bitonic_sort, _prefix_sum, _pick and
// _seg_sse).  Per row r it vets arena[starts[r] : starts[r] + lengths[r]]:
// exact sort with +inf padding -> log(max(y, 1e-12)) -> centring on the
// element at (n-1)/2 -> three inclusive prefix sums -> two-segment SSE for
// every k in [omega, n-omega] -> lowest-index argmin t -> capped linear
// extrapolation -> EI, OC.  Output lanes [pr/ei, ei, oc, pr, t, n, 0, 0].
//
// What bounds it on an H100: neither bytes nor arithmetic.  A row of n
// records is read once (4n bytes) and costs O(n log^2 n) compare-exchanges
// plus ~60 f32 operations per record, so the card's floor is a few
// microseconds for a whole mux tick.  What a kernel pays is latency: a
// bitonic network is log2(w)(log2(w)+1)/2 dependent stages, and a block
// barrier after each one costs more than the stage's work.  So the design
// keeps a row inside one warp wherever it can, and sorts each row at its
// own width, never at the launch's.
//
// Row width: w = max(32, pow2(n)).  A row is sorted by a bitonic network of
// width w over the slots [0, w): +inf from n up, and nothing past w is
// touched (it would be +inf, already at the tail).  Compare/select only,
// so the sort is exact (torch.sort's values).
//
// Warp path (launch width lmax <= kWarpMaxLmax): one warp per row, 8 rows
// per 256-thread block, no block barrier.  The row lives in registers, EW =
// w/32 consecutive values per lane (element i = lane*EW + e); the kernel is
// instantiated for E = lmax/32 and each row runs the routine of its own EW
// <= E.  Strides below EW are exchanged inside a lane, larger ones with
// __shfl_xor_sync.  The prefix sums keep XLA's order in registers: a
// 16-block spans 16/EW lanes when EW < 16, and the running sum is handed
// lane to lane by shuffle, so the adds stay serial; the block totals go to
// the warp's slice of shared memory, each lane scans them by the same rule
// up to its own block and adds that block's exclusive carry last.  The SSE
// loop then reads the prefix sums back from the slice one cut at a time,
// which keeps the kernel at 63 registers for 8 values a lane (four blocks
// an SM where the row held in registers took 106 and two).  Argmin, picks
// and sums are shuffles.
//
// Block path (lmax > kWarpMaxLmax, up to 4096): one block of lmax/8
// threads per row, 8 consecutive values per thread.  Strides below 8 stay
// in a thread, strides below 256 go by shuffle, and only the strides of 256
// and more go through shared memory with a barrier (10 stages at w = 4096,
// against 78 barriers for a network in shared memory).  The prefix sums use
// the level scheme of common.cuh (xla_scan3), as the change-point kernel
// does.  Shared memory: the sorted row (padded, one word per 16 values) and
// the scans, 73 KB at lmax = 4096.
//
// Rounding: every f32 step goes through the rn_* helpers or __fmaf_rn, so
// nothing is contracted and each step is one IEEE operation in a fixed
// order: the log is core/changepoint.py::xla_order_log (Cephes reduction
// and polynomial), the prefix sums xla_order_cumsum's order, sx1/sxx1 the
// reference's f32 expression order (kernel.py:191-194), and EI and OC are
// balanced pairwise trees over the row's slots (ops.py::_tree_sum).  None
// of these depends on the launch's width, so a row's lanes are the same in
// any launch and on either path, and equal to the plain PyTorch version
// (ops.py::fused_window_vet_plain) bit for bit.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kMaxLmax = 4096;
constexpr int kWarpMaxLmax = 512;  // widest launch of the warp path
constexpr int kRowsPerBlock = 8;  // warp path: one warp per row
constexpr int kBlockElems = 8;  // block path: values per thread
constexpr int kBlockMaxThreads = kMaxLmax / kBlockElems;
constexpr float kTiny = 0x1.197998p-40f;  // 1e-12f, the log-space floor

// XLA's CPU log (core/changepoint.py::xla_order_log): the Cephes
// polynomial's coefficients in evaluation order, ln 2 split in two, and
// sqrt(1/2), all as f32.
constexpr float kLogP0 = 0x1.204376p-4f;
constexpr float kLogP1 = -0x1.d7a370p-4f;
constexpr float kLogP2 = 0x1.de4a34p-4f;
constexpr float kLogP3 = -0x1.fcba9ep-4f;
constexpr float kLogP4 = 0x1.23d37ep-3f;
constexpr float kLogP5 = -0x1.555ca0p-3f;
constexpr float kLogP6 = 0x1.999d58p-3f;
constexpr float kLogP7 = -0x1.fffff8p-3f;
constexpr float kLogP8 = 0x1.555554p-2f;
constexpr float kLogQ1 = -0x1.bd0106p-13f;
constexpr float kLogQ2 = 0x1.630000p-1f;
constexpr float kSqrtHalf = 0x1.6a09e6p-1f;

// log(x) for x in [1e-12, +inf], as xla_order_log computes it.
__device__ __forceinline__ float xla_log(float x) {
  if (x == inf_f()) return x;
  const int bits = __float_as_int(x);
  float e = rn_add(static_cast<float>((bits >> 23) - 127), 1.0f);
  const float m = __int_as_float((bits & ~0x7F800000) | 0x3F000000);
  const bool low = m < kSqrtHalf;
  e = rn_sub(e, low ? 1.0f : 0.0f);
  const float r = rn_add(rn_sub(m, 1.0f), low ? m : 0.0f);
  const float r2 = rn_mul(r, r), r3 = rn_mul(r2, r);
  float y0 = __fmaf_rn(r, kLogP0, kLogP1);
  float y1 = __fmaf_rn(r, kLogP3, kLogP4);
  float y2 = __fmaf_rn(r, kLogP6, kLogP7);
  y0 = __fmaf_rn(y0, r, kLogP2);
  y1 = __fmaf_rn(y1, r, kLogP5);
  y2 = __fmaf_rn(y2, r, kLogP8);
  float y = __fmaf_rn(y0, r3, y1);
  y = __fmaf_rn(y, r3, y2);
  y = __fmaf_rn(y, r3, rn_mul(e, kLogQ1));
  return rn_add(rn_add(rn_sub(r, rn_mul(r2, 0.5f)), y), rn_mul(e, kLogQ2));
}

__device__ __forceinline__ float vet_z(float y, int log_space) {
  return log_space ? xla_log(fmaxf(y, kTiny)) : y;
}

__host__ __device__ constexpr int log2_of(int x) {
  return x > 1 ? 1 + log2_of(x / 2) : 0;
}

// The row's sort width: max(32, pow2(n)).
__device__ __forceinline__ int row_width(int n) {
  return n <= 32 ? 32 : 1 << (32 - __clz(n - 1));
}

// One row's constants for the SSE of every cut.
struct Cut {
  float nf, sx_tot, sxx_tot, klo, khi, tot[3];
};

__device__ __forceinline__ Cut cut_of(int n, int omega, const float tot[3]) {
  Cut c;
  c.nf = static_cast<float>(n);
  const float nn = rn_mul(c.nf, rn_add(c.nf, 1.0f));
  c.sx_tot = rn_mul(nn, 0.5f);
  c.sxx_tot = rn_div(rn_mul(nn, rn_add(rn_mul(2.0f, c.nf), 1.0f)), 6.0f);
  c.klo = static_cast<float>(omega);
  c.khi = rn_sub(c.nf, static_cast<float>(omega));
  for (int k = 0; k < 3; ++k) c.tot[k] = tot[k];
  return c;
}

// Two-segment SSE of the cut after element i (k = i + 1) from the prefix
// sums cs = (z, z*z, k*z) at i; +inf outside [omega, n - omega].
__device__ __forceinline__ float cut_sse(int i, const float cs[3],
                                         const Cut& c) {
  const float kf = static_cast<float>(i + 1);
  const float kk = rn_mul(kf, rn_add(kf, 1.0f));
  const float sx1 = rn_mul(kk, 0.5f);
  const float sxx1 = rn_div(rn_mul(kk, rn_add(rn_mul(2.0f, kf), 1.0f)), 6.0f);
  const float s1 = seg_sse(kf, sx1, cs[0], sxx1, cs[2], cs[1]);
  const float s2 = seg_sse(rn_sub(c.nf, kf), rn_sub(c.sx_tot, sx1),
                           rn_sub(c.tot[0], cs[0]), rn_sub(c.sxx_tot, sxx1),
                           rn_sub(c.tot[2], cs[2]), rn_sub(c.tot[1], cs[1]));
  return (kf >= c.klo && kf <= c.khi) ? rn_add(s1, s2) : inf_f();
}

// EI and OC terms of element i (rank i + 1) with value y, cut tb.
__device__ __forceinline__ void ei_oc_terms(int i, int n, float y, int tb,
                                            float anchor, float slope,
                                            float& ei, float& oc) {
  const int rank = i + 1;
  if (i >= n) {
    ei = 0.0f;
    oc = 0.0f;
  } else if (rank <= tb) {
    ei = y;
    oc = 0.0f;
  } else {
    const float g =
        fminf(rn_add(anchor, rn_mul(slope, static_cast<float>(rank - tb))), y);
    ei = g;
    oc = rn_sub(y, g);
  }
}

__device__ __forceinline__ void write_lanes(float* o, float pr, float ei,
                                            float oc, int tb, int n) {
  reinterpret_cast<float4*>(o)[0] = make_float4(rn_div(pr, ei), ei, oc, pr);
  reinterpret_cast<float4*>(o)[1] =
      make_float4(static_cast<float>(tb), static_cast<float>(n), 0.0f, 0.0f);
}

// ---- bitonic network over v[EW] per thread, element i = t*EW + e ---------
// Element i keeps the smaller of itself and element i^j when
// (i & j == 0) == (i & k == 0): an ascending sort at the last merge k = w.

// Strides JJ < EW: compare-exchanges inside the thread, JJ = EW/2 .. 1.
// The pair's direction bit (i & k) is the thread's for k >= EW, e's below.
template <int JJ, int EW>
__device__ __forceinline__ void sort_in_thread(float (&v)[EW], int t, int k) {
  if constexpr (JJ >= 1) {
    if (JJ < k) {
      const bool up_t = ((t * EW) & k) == 0;
#pragma unroll
      for (int e = 0; e < EW; ++e) {
        if ((e & JJ) == 0) {
          const bool up = up_t && (e & k) == 0;
          const float a = v[e], b = v[e + JJ];
          v[e] = up ? fminf(a, b) : fmaxf(a, b);
          v[e + JJ] = up ? fmaxf(a, b) : fminf(a, b);
        }
      }
    }
    sort_in_thread<JJ / 2, EW>(v, t, k);
  }
}

// Stride j in [EW, 32 * EW): the partner is lane ^ (j / EW), and both
// direction bits (j, k >= EW) are the thread's.
template <int EW>
__device__ __forceinline__ void sort_by_shuffle(float (&v)[EW], int t, int k,
                                                int j) {
  const int lm = j / EW, i0 = t * EW;
  const bool keep_min = ((i0 & j) == 0) == ((i0 & k) == 0);
#pragma unroll
  for (int e = 0; e < EW; ++e) {
    const float o = __shfl_xor_sync(kFullMask, v[e], lm);
    v[e] = keep_min ? fminf(v[e], o) : fmaxf(v[e], o);
  }
}

// v[e] of element idx (the same idx in every lane) from the lane that
// holds it.
template <int EW>
__device__ __forceinline__ float warp_pick(const float (&v)[EW], int idx) {
  const int e_idx = idx % EW;
  float x = v[0];
#pragma unroll
  for (int e = 1; e < EW; ++e)
    if (e == e_idx) x = v[e];
  return __shfl_sync(kFullMask, x, idx / EW);
}

// Pairwise tree over v[EW] (neighbours first), then over the lanes.
template <int EW>
__device__ __forceinline__ float warp_tree_sum(float (&v)[EW]) {
#pragma unroll
  for (int h = 1; h < EW; h <<= 1)
#pragma unroll
    for (int e = 0; e < EW; e += 2 * h) v[e] = rn_add(v[e], v[e + h]);
  float s = v[0];
#pragma unroll
  for (int d = 1; d < 32; d <<= 1)
    s = rn_add(s, __shfl_xor_sync(kFullMask, s, d));
  return s;
}

// ---- the warp path: one row in one warp's registers -----------------------
template <int EW>
__device__ __forceinline__ void vet_row_warp(const float* __restrict__ src,
                                             int n, float pr, float* o,
                                             float* cs, float* tots,
                                             int omega, int log_space,
                                             int lane) {
  constexpr int kW = 32 * EW, kLogW = log2_of(kW), kLogEW = log2_of(EW);
  constexpr int kNB = kW / kScanBlock;  // 16-blocks in the row's width
  static_assert(kNB <= 2 * kScanBlock, "level 1 spans at most two blocks");
  float y[EW];
#pragma unroll
  for (int e = 0; e < EW; ++e) {
    const int i = lane * EW + e;
    y[e] = i < n ? src[i] : inf_f();
  }

  // exact bitonic sort at the row's width (k = 2^lk, j = 2^lj: counted
  // loops, unrolled whole)
#pragma unroll
  for (int lk = 1; lk <= kLogW; ++lk) {
#pragma unroll
    for (int lj = lk - 1; lj >= kLogEW; --lj)
      sort_by_shuffle<EW>(y, lane, 1 << lk, 1 << lj);
    sort_in_thread<EW / 2, EW>(y, lane, 1 << lk);
  }

  // log, centre on the element (n-1)/2, scan inputs
  const float pivot = vet_z(warp_pick<EW>(y, (n - 1) / 2), log_space);
  float a[3][EW];
#pragma unroll
  for (int e = 0; e < EW; ++e) {
    const int i = lane * EW + e;
    const float zm = i < n ? rn_sub(vet_z(y[e], log_space), pivot) : 0.0f;
    a[0][e] = zm;
    a[1][e] = rn_mul(zm, zm);
    a[2][e] = rn_mul(static_cast<float>(i + 1), zm);
  }

  // level 0: serial adds inside each 16-block, handed lane to lane
  constexpr int kG = EW < kScanBlock ? kScanBlock / EW : 1;  // lanes a block
  const int g = lane % kG;
  float run[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int s = 0; s < kG; ++s) {
    float in[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      in[c] = s > 0 ? __shfl_up_sync(kFullMask, run[c], 1) : 0.0f;
    if (g == s) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
#pragma unroll
        for (int e = 0; e < EW; ++e) {
          const bool first = (e % kScanBlock) == 0 && (e > 0 || s == 0);
          const float prev = e > 0 ? a[c][e - 1] : in[c];
          if (!first) a[c][e] = rn_add(prev, a[c][e]);
        }
        run[c] = a[c][EW - 1];
      }
    }
  }

  // level 1: the block totals go to the warp's slice of `tots`; each lane
  // scans them by the same rule (one 16-block, or two with the first one's
  // total carried into the second) up to its own block and adds that
  // block's exclusive carry, +0 for block 0.
  const int my_b = (lane * EW) / kScanBlock;
  if (g == kG - 1)
#pragma unroll
    for (int c = 0; c < 3; ++c) tots[c * kNB + my_b] = a[c][EW - 1];
  __syncwarp();
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float s1 = 0.0f, top = 0.0f, carry = 0.0f;
#pragma unroll 4
    for (int b = 0; b < my_b; ++b) {
      const float bt = tots[c * kNB + b];
      s1 = b % kScanBlock == 0 ? bt : rn_add(s1, bt);
      carry = s1;
      if (kNB > kScanBlock) carry = rn_add(s1, b < kScanBlock ? 0.0f : top);
      if (b == kScanBlock - 1) top = s1;
    }
#pragma unroll
    for (int e = 0; e < EW; ++e) a[c][e] = rn_add(a[c][e], carry);
  }

  // SSE of every cut, lowest-index argmin.  The prefix sums wait in the
  // warp's slice of shared memory ([c][e][lane]: each lane reads back only
  // its own words, conflict-free), so a rolled loop keeps one cut's
  // operands in registers, not the row's.
  float tot[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    tot[c] = warp_pick<EW>(a[c], n - 1);
#pragma unroll
    for (int e = 0; e < EW; ++e) cs[(c * EW + e) * 32 + lane] = a[c][e];
  }
  const Cut cut = cut_of(n, omega, tot);
  float best = inf_f();
  int best_i = INT_MAX;
  // one cut at a time from 8 values a lane up; unrolled below (ptxas
  // spills around the division's slow-path call in the rolled loop there)
  constexpr int kSseUnroll = EW >= 8 ? 1 : EW;
#pragma unroll kSseUnroll
  for (int e = 0; e < EW; ++e) {
    const int i = lane * EW + e;
    if (i < n) {
      const float c3[3] = {cs[e * 32 + lane], cs[(EW + e) * 32 + lane],
                           cs[(2 * EW + e) * 32 + lane]};
      const float v = cut_sse(i, c3, cut);
      if (v < best) {  // i ascends in a lane: keeps the first minimum
        best = v;
        best_i = i;
      }
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    argmin_merge(best, best_i, __shfl_xor_sync(kFullMask, best, d),
                 __shfl_xor_sync(kFullMask, best_i, d));
  const int tb = (best_i == INT_MAX ? 0 : best_i) + 1;  // 1-indexed cut

  // capped linear extrapolation -> EI / OC
  const int ia = min(max(tb - 1, 1), n - 1);
  const float anchor = warp_pick<EW>(y, ia);
  const float slope = fmaxf(rn_sub(anchor, warp_pick<EW>(y, ia - 1)), 0.0f);
  float ev[EW], ov[EW];
#pragma unroll
  for (int e = 0; e < EW; ++e)
    ei_oc_terms(lane * EW + e, n, y[e], tb, anchor, slope, ev[e], ov[e]);
  const float ei = warp_tree_sum<EW>(ev);
  const float oc = warp_tree_sum<EW>(ov);
  if (lane == 0) write_lanes(o, pr, ei, oc, tb, n);
}

// Shared floats of one warp of the warp path: the prefix sums of a row of
// 32 * E values and the totals of its 2 * E blocks of 16, three channels.
__host__ __device__ constexpr int warp_slice(int e) { return 3 * 34 * e; }

template <int E>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
windowvet_warp_kernel(const float* __restrict__ arena,
                      const int* __restrict__ starts,
                      const int* __restrict__ lengths,
                      const float* __restrict__ pr, float* __restrict__ out,
                      int rows, int omega, int log_space) {
  extern __shared__ float smem[];  // warp_slice(E) floats a warp
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row >= rows) return;
  float* cs = smem + warp * warp_slice(E);  // prefix sums, [c][e][lane]
  float* tots = cs + 3 * 32 * E;  // 16-block totals, [c][b]
  const int n = lengths[row];
  const float* src = arena + starts[row];
  float* o = out + 8 * static_cast<size_t>(row);
  const float p = pr[row];
  switch (row_width(n) / 32) {  // n <= lmax, so at most E
    case 1:
      vet_row_warp<1>(src, n, p, o, cs, tots, omega, log_space, lane);
      break;
    case 2:
      if constexpr (E >= 2)
        vet_row_warp<2>(src, n, p, o, cs, tots, omega, log_space, lane);
      break;
    case 4:
      if constexpr (E >= 4)
        vet_row_warp<4>(src, n, p, o, cs, tots, omega, log_space, lane);
      break;
    case 8:
      if constexpr (E >= 8)
        vet_row_warp<8>(src, n, p, o, cs, tots, omega, log_space, lane);
      break;
    case 16:
      if constexpr (E >= 16)
        vet_row_warp<16>(src, n, p, o, cs, tots, omega, log_space, lane);
      break;
  }
}

// ---- the block path: one row in one block ---------------------------------
__global__ void __launch_bounds__(kBlockMaxThreads)
windowvet_block_kernel(const float* __restrict__ arena,
                       const int* __restrict__ starts,
                       const int* __restrict__ lengths,
                       const float* __restrict__ pr, float* __restrict__ out,
                       int lmax, int omega, int log_space) {
  constexpr int EW = kBlockElems;
  extern __shared__ float smem[];
  float* ys = smem;  // the row at padded(i): sort exchange, then sorted
  float* buf = smem + padded(lmax);  // the scans (levels_of(n))
  __shared__ float sv[32];
  __shared__ int si[32];
  const int row = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int n = lengths[row];
  const float* src = arena + starts[row];
  const int w = row_width(n);

  float y[EW];
#pragma unroll
  for (int e = 0; e < EW; ++e) {
    const int i = tid * EW + e;
    y[e] = i < n ? src[i] : inf_f();
  }

  // exact bitonic sort at the row's width; the threads past w hold +inf
  // and only ever meet each other
  for (int k = 2; k <= w; k <<= 1) {
    int j = k >> 1;
    for (; j >= 32 * EW; j >>= 1) {  // across warps: through shared memory
#pragma unroll
      for (int e = 0; e < EW; ++e) ys[padded(tid * EW + e)] = y[e];
      __syncthreads();
      const int i0 = tid * EW;
      const bool keep_min = ((i0 & j) == 0) == ((i0 & k) == 0);
#pragma unroll
      for (int e = 0; e < EW; ++e) {
        const float o = ys[padded((i0 + e) ^ j)];
        y[e] = keep_min ? fminf(y[e], o) : fmaxf(y[e], o);
      }
      __syncthreads();
    }
    for (; j >= EW; j >>= 1) sort_by_shuffle<EW>(y, tid, k, j);
    sort_in_thread<EW / 2, EW>(y, tid, k);
  }
#pragma unroll
  for (int e = 0; e < EW; ++e) ys[padded(tid * EW + e)] = y[e];
  __syncthreads();

  // log, centre on the element (n-1)/2, stage z for the scans
  const Levels lv = levels_of(n);
  const float pivot = vet_z(ys[padded((n - 1) / 2)], log_space);
  const Chans s0 = chans(buf, lv, 0);
#pragma unroll
  for (int e = 0; e < EW; ++e) {
    const int i = tid * EW + e;
    if (i < lv.nb[0] * kScanBlock)
      s0.c[0][padded(i)] = i < n ? rn_sub(vet_z(y[e], log_space), pivot) : 0.0f;
  }
  __syncthreads();
  xla_scan3(buf, lv, tid, nt);
  const ScanView scan = scan_view(buf, lv);
  float tot[3];
  prefix3(scan, n - 1, tot);

  // SSE of every cut, lowest-index argmin
  const Cut cut = cut_of(n, omega, tot);
  float best = inf_f();
  int best_i = INT_MAX;
#pragma unroll
  for (int e = 0; e < EW; ++e) {
    const int i = tid * EW + e;
    if (i < n) {
      float cs[3];
      prefix3(scan, i, cs);
      const float v = cut_sse(i, cs, cut);
      if (v < best) {
        best = v;
        best_i = i;
      }
    }
  }
  const int win = block_argmin(best, best_i, sv, si);  // ends synced
  const int tb = (win == INT_MAX ? 0 : win) + 1;

  // capped linear extrapolation -> EI / OC: pairwise trees over the
  // thread's values, the lanes, then the warps
  const int ia = min(max(tb - 1, 1), n - 1);
  const float anchor = ys[padded(ia)];
  const float slope = fmaxf(rn_sub(anchor, ys[padded(ia - 1)]), 0.0f);
  float ev[EW], ov[EW];
#pragma unroll
  for (int e = 0; e < EW; ++e)
    ei_oc_terms(tid * EW + e, n, y[e], tb, anchor, slope, ev[e], ov[e]);
  float ei = warp_tree_sum<EW>(ev);
  float oc = warp_tree_sum<EW>(ov);
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  if (lane == 0) {
    sv[warp] = ei;
    sv[16 + warp] = oc;
  }
  __syncthreads();
  if (warp == 0) {
    ei = lane < nw ? sv[lane] : 0.0f;
    oc = lane < nw ? sv[16 + lane] : 0.0f;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      ei = rn_add(ei, __shfl_xor_sync(kFullMask, ei, d));
      oc = rn_add(oc, __shfl_xor_sync(kFullMask, oc, d));
    }
    if (lane == 0)
      write_lanes(out + 8 * static_cast<size_t>(row), pr[row], ei, oc, tb, n);
  }
}

// Floats of the block path's dynamic shared memory for launch width lmax:
// the padded row and the scans of an lmax-element row (levels_of).
int block_smem_floats(int lmax) {
  int total = lmax + lmax / kScanBlock, m = lmax;
  while (true) {
    const int nb = (m + kScanBlock - 1) / kScanBlock;
    total += 3 * kScanPad * nb;
    if (nb == 1) return total;
    m = nb;
  }
}

}  // namespace
}  // namespace repro_torch

// Vet `rows` windows of `arena`: out is (rows, 8) f32.  arena f32 (covering
// starts[r] + lengths[r] for every row), starts/lengths int32, pr f32, all
// contiguous on the stream's device, out 16-byte aligned; lmax a power of
// two in [8, 4096] with 2 <= lengths[r] <= lmax.  Returns cudaGetLastError()
// after the launch.
extern "C" int windowvet_fused(const float* arena, const int* starts,
                               const int* lengths, const float* pr,
                               float* out, int rows, int lmax, int omega,
                               int log_space, cudaStream_t stream) {
  using namespace repro_torch;
  if (rows <= 0 || lmax < 8 || lmax > kMaxLmax || (lmax & (lmax - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (lmax <= kWarpMaxLmax) {
    const auto launch = [&](auto kernel, int e) {
      const int grid = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
      const size_t smem = sizeof(float) * warp_slice(e) * kRowsPerBlock;
      if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
      }
      kernel<<<grid, 32 * kRowsPerBlock, smem, stream>>>(
          arena, starts, lengths, pr, out, rows, omega, log_space);
      return static_cast<int>(cudaGetLastError());
    };
    switch (lmax <= 32 ? 1 : lmax / 32) {
      case 1: return launch(windowvet_warp_kernel<1>, 1);
      case 2: return launch(windowvet_warp_kernel<2>, 2);
      case 4: return launch(windowvet_warp_kernel<4>, 4);
      case 8: return launch(windowvet_warp_kernel<8>, 8);
      default: return launch(windowvet_warp_kernel<16>, 16);
    }
  }
  const size_t smem = sizeof(float) * block_smem_floats(lmax);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        windowvet_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  windowvet_block_kernel<<<rows, lmax / kBlockElems, smem, stream>>>(
      arena, starts, lengths, pr, out, lmax, omega, log_space);
  return static_cast<int>(cudaGetLastError());
}
