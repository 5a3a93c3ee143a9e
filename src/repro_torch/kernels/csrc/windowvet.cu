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
// microseconds for a whole mux tick; what the kernel actually pays is
// latency — the bitonic network's log2(lmax)*(log2(lmax)+1)/2 block-wide
// barriers and the scans' shuffle ladders.
//
// Design: one thread block per row, so rows need no coordination and the
// ragged set is just the grid.  The TPU kernel replicated the whole arena
// into every grid step's VMEM and sliced rows out of it; here each block
// reads its own row straight from global memory at starts[r] (coalesced),
// so nothing is replicated.  The sorted row and the three scans live in
// dynamic shared memory: 16*lmax bytes, 64 KiB at lmax = 4096, above the
// 48 KiB default, so the launcher raises the kernel's
// cudaFuncAttributeMaxDynamicSharedMemorySize.  Sort: a bitonic network in
// shared memory (compare/exchange only, so exact).  Scans: each thread scans
// a contiguous chunk serially, then a warp-shuffle ladder and one pass over
// the warp totals add the chunk offsets.  The argmin keeps the first
// minimum per thread and reduces (value, index) pairs with the lowest index
// winning ties; an all-inf row (n < 2*omega) gives t = 1, as jnp.argmin
// does.  sx1/sxx1 are evaluated in f32 in the reference's expression order
// (kernel.py:191-194).  The scans round differently from a sequential
// cumsum (so the cut may move between statistical near-ties against the
// reference); the plain version (ops.py block_scan) adds in this kernel's
// order, so on the card the two agree on the cut.
#include <algorithm>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kMaxLmax = 4096;
constexpr int kMaxThreads = 1024;
constexpr float kTiny = 1e-12f;

// Exclusive block-wide scan of three values per thread.  blockDim.x must be
// a multiple of 32; `ws` is [3][32] scratch.
__device__ __forceinline__ void block_exclusive_scan3(const float v[3],
                                                      float ex[3],
                                                      float (*ws)[32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  float inc[3] = {v[0], v[1], v[2]};
  for (int d = 1; d < 32; d <<= 1) {
    for (int c = 0; c < 3; ++c) {
      const float o = __shfl_up_sync(kFullMask, inc[c], d);
      if (lane >= d) inc[c] = rn_add(inc[c], o);
    }
  }
  float excl[3];
  for (int c = 0; c < 3; ++c) {
    const float o = __shfl_up_sync(kFullMask, inc[c], 1);
    excl[c] = lane == 0 ? 0.0f : o;
  }
  if (lane == 31)
    for (int c = 0; c < 3; ++c) ws[c][warp] = inc[c];
  __syncthreads();
  if (warp == 0) {
    for (int c = 0; c < 3; ++c) {
      float w = lane < nw ? ws[c][lane] : 0.0f;
      for (int d = 1; d < 32; d <<= 1) {
        const float o = __shfl_up_sync(kFullMask, w, d);
        if (lane >= d) w = rn_add(w, o);
      }
      const float prev = __shfl_up_sync(kFullMask, w, 1);
      ws[c][lane] = lane == 0 ? 0.0f : prev;  // exclusive over warps
    }
  }
  __syncthreads();
  for (int c = 0; c < 3; ++c)
    ex[c] = warp == 0 ? excl[c] : rn_add(ws[c][warp], excl[c]);
  __syncthreads();
}

__device__ __forceinline__ float block_sum(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  for (int d = 16; d > 0; d >>= 1)
    v = rn_add(v, __shfl_down_sync(kFullMask, v, d));
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < nw ? scratch[lane] : 0.0f;
    for (int d = 16; d > 0; d >>= 1)
      v = rn_add(v, __shfl_down_sync(kFullMask, v, d));
    if (lane == 0) scratch[0] = v;
  }
  __syncthreads();
  const float total = scratch[0];
  __syncthreads();
  return total;
}

__global__ void __launch_bounds__(kMaxThreads)
windowvet_kernel(const float* __restrict__ arena,
                 const int* __restrict__ starts,
                 const int* __restrict__ lengths,
                 const float* __restrict__ pr, float* __restrict__ out,
                 int lmax, int omega, int log_space) {
  extern __shared__ float smem[];
  float* ys = smem;            // sorted row, +inf past n
  float* cy = ys + lmax;       // prefix sums of z, z^2, k*z
  float* cyy = cy + lmax;
  float* cxy = cyy + lmax;
  __shared__ float ws[3][32];
  __shared__ float sv[32];
  __shared__ int si[32];

  const int row = blockIdx.x;
  const int n = lengths[row];
  const float* src = arena + starts[row];
  const int tid = threadIdx.x, nt = blockDim.x;

  // ---- load the row in place from global memory, +inf padding ----------
  for (int i = tid; i < lmax; i += nt) ys[i] = i < n ? src[i] : inf_f();
  __syncthreads();

  // ---- exact bitonic sort, ascending ----------------------------------
  for (int k = 2; k <= lmax; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < lmax; i += nt) {
        const int p = i ^ j;
        if (p > i) {
          const float a = ys[i], b = ys[p];
          const bool up = (i & k) == 0;
          if (up ? (a > b) : (a < b)) {
            ys[i] = b;
            ys[p] = a;
          }
        }
      }
      __syncthreads();
    }
  }

  // ---- log, centre on the midpoint element, scan inputs ----------------
  const float yp = ys[(n - 1) / 2];
  const float pivot = log_space ? logf(fmaxf(yp, kTiny)) : yp;
  for (int i = tid; i < lmax; i += nt) {
    float zm = 0.0f;
    if (i < n) {
      const float z = log_space ? logf(fmaxf(ys[i], kTiny)) : ys[i];
      zm = rn_sub(z, pivot);
    }
    cy[i] = zm;
    cyy[i] = rn_mul(zm, zm);
    cxy[i] = rn_mul(static_cast<float>(i + 1), zm);
  }
  __syncthreads();

  // ---- three inclusive scans: serial chunk, then block offsets ---------
  {
    const int chunk = (lmax + nt - 1) / nt;
    const int lo = min(tid * chunk, lmax), hi = min(lo + chunk, lmax);
    float acc[3] = {0.0f, 0.0f, 0.0f};
    for (int i = lo; i < hi; ++i) {
      acc[0] = rn_add(acc[0], cy[i]);
      cy[i] = acc[0];
      acc[1] = rn_add(acc[1], cyy[i]);
      cyy[i] = acc[1];
      acc[2] = rn_add(acc[2], cxy[i]);
      cxy[i] = acc[2];
    }
    float ex[3];
    block_exclusive_scan3(acc, ex, ws);
    for (int i = lo; i < hi; ++i) {
      cy[i] = rn_add(cy[i], ex[0]);
      cyy[i] = rn_add(cyy[i], ex[1]);
      cxy[i] = rn_add(cxy[i], ex[2]);
    }
  }
  __syncthreads();

  // ---- two-segment SSE for every k, fused lowest-index argmin ----------
  const float tot_y = cy[n - 1], tot_yy = cyy[n - 1], tot_xy = cxy[n - 1];
  const float nf = static_cast<float>(n);
  const float sx_tot = rn_mul(rn_mul(nf, rn_add(nf, 1.0f)), 0.5f);
  const float sxx_tot =
      rn_div(rn_mul(rn_mul(nf, rn_add(nf, 1.0f)), rn_add(rn_mul(2.0f, nf), 1.0f)), 6.0f);
  const float klo = static_cast<float>(omega);
  const float khi = rn_sub(nf, static_cast<float>(omega));
  float best = inf_f();
  int best_i = INT_MAX;
  for (int i = tid; i < n; i += nt) {
    const float kf = static_cast<float>(i + 1);
    const float sx1 = rn_mul(rn_mul(kf, rn_add(kf, 1.0f)), 0.5f);
    const float sxx1 =
        rn_div(rn_mul(rn_mul(kf, rn_add(kf, 1.0f)), rn_add(rn_mul(2.0f, kf), 1.0f)), 6.0f);
    const float s1 = seg_sse(kf, sx1, cy[i], sxx1, cxy[i], cyy[i]);
    const float s2 = seg_sse(rn_sub(nf, kf), rn_sub(sx_tot, sx1), rn_sub(tot_y, cy[i]),
                             rn_sub(sxx_tot, sxx1), rn_sub(tot_xy, cxy[i]),
                             rn_sub(tot_yy, cyy[i]));
    const float v = (kf >= klo && kf <= khi) ? rn_add(s1, s2) : inf_f();
    if (v < best) {
      best = v;
      best_i = i;
    }
  }
  const int win = block_argmin(best, best_i, sv, si);
  const int tb = (win == INT_MAX ? 0 : win) + 1;  // 1-indexed cut

  // ---- capped linear extrapolation -> EI / OC --------------------------
  const int ia = min(max(tb - 1, 1), n - 1);
  const float anchor = ys[ia];
  const float slope = fmaxf(rn_sub(anchor, ys[ia - 1]), 0.0f);
  float ei = 0.0f, oc = 0.0f;
  for (int i = tid; i < n; i += nt) {
    const float y = ys[i];
    const int rank = i + 1;
    if (rank <= tb) {
      ei = rn_add(ei, y);
    } else {
      const float g =
          fminf(rn_add(anchor, rn_mul(slope, static_cast<float>(rank - tb))), y);
      ei = rn_add(ei, g);
      oc = rn_add(oc, rn_sub(y, g));
    }
  }
  ei = block_sum(ei, sv);
  oc = block_sum(oc, sv);
  if (tid == 0) {
    float* o = out + 8 * static_cast<size_t>(row);
    o[0] = rn_div(pr[row], ei);
    o[1] = ei;
    o[2] = oc;
    o[3] = pr[row];
    o[4] = static_cast<float>(tb);
    o[5] = nf;
    o[6] = 0.0f;
    o[7] = 0.0f;
  }
}

}  // namespace
}  // namespace repro_torch

// Vet `rows` windows of `arena`: out is (rows, 8) f32.  arena f32 (covering
// starts[r] + lengths[r] for every row), starts/lengths int32, pr f32, all
// contiguous on the stream's device; lmax a power of two in [8, 4096] with
// 2 <= lengths[r] <= lmax.  Returns cudaGetLastError() after the launch.
extern "C" int windowvet_fused(const float* arena, const int* starts,
                               const int* lengths, const float* pr,
                               float* out, int rows, int lmax, int omega,
                               int log_space, cudaStream_t stream) {
  using namespace repro_torch;
  if (rows <= 0 || lmax < 8 || lmax > kMaxLmax || (lmax & (lmax - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = std::max(32, std::min(kMaxThreads, lmax));
  const size_t smem = 4 * sizeof(float) * static_cast<size_t>(lmax);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        windowvet_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  windowvet_kernel<<<rows, threads, smem, stream>>>(
      arena, starts, lengths, pr, out, lmax, omega, log_space);
  return static_cast<int>(cudaGetLastError());
}
