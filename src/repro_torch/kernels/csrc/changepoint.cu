// The paper's change-point estimator (§4.3) in one kernel, for Hopper
// (sm_90a): from sorted values to t, over a ragged batch of rows.
//
// Replaces: src/repro/kernels/changepoint/kernel.py::sse_scan (the Pallas
// body _kernel) and what the reference does around it per row: centring,
// jnp.cumsum of z, z^2 and k*z, the f64 index closed forms, and the
// jnp.argmin on the host side (ops.py::changepoint_pallas under vmap, and
// once per ring in fleet/anomaly.py).
//
// What bounds it on an H100: bytes.  Per element the kernel reads one f32
// value and does ~45 f32 operations (centre, two products, three scan adds
// and three carry adds, two segment SSEs, mask, argmin step); the landscape,
// when asked for, is one f32 write.  ~45 operations per 4-8 bytes is below
// the ~20 operations per byte at which the f32 units (67 TFLOP/s against
// 3.35 TB/s) would become the limit.  So a block streams its row once with
// coalesced loads and keeps every intermediate on the SM: the prefix sums
// never go to device memory, and tensor cores and TMA have no part here.
//
// Design: one thread block per row (a grid-stride loop over rows), no state
// across blocks.  Per row:
//   1. z = y - y[(n-1)//2], staged into shared memory (coalesced loads);
//   2. the three inclusive prefix sums in the order XLA adds jnp.cumsum on
//      the CPU (core/changepoint.py::xla_order_cumsum): serial adds inside
//      blocks of 16 with the tail zero-padded, the block totals scanned by
//      the same rule recursively, each block's exclusive carry added last.
//      One thread per 16-block at every level; a level's arrays hold one
//      pad word after every 16 values so those threads hit distinct banks;
//   3. the index closed forms in f64, rounded once to f32 (exact integers
//      for any n the port sees, so equal to index_closed_forms(n) in f32);
//   4. both segment SSEs (common.cuh::seg_sse), the +inf mask outside
//      [omega, n - omega], the optional landscape write and the argmin
//      (lowest index wins a tie, an all-inf row gives t = 1).
// Every f32 step goes through the rn_* helpers, so nothing is contracted
// into a multiply-add: the landscape and t equal the plain PyTorch version
// (ops.py::changepoint_ragged_plain) bit for bit.
//
// The scans need kScanPad * 3 floats per 16 elements at each level (about
// 12.8 bytes per element).  They live in dynamic shared memory while that
// fits in kSharedFloats (rows up to ~17K elements).  Longer rows (an
// unbucketed 65,536-record profile) run the same code on a per-block slice
// of a global scratch buffer that the wrapper allocates.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kMaxThreads = 1024;
// Dynamic shared memory a block may take for the scans: the opt-in limit
// (232,448 bytes) less 1 KiB kept for the static argmin scratch.
constexpr int kSharedFloats = (232448 - 1024) / 4;

// k(k+1)/2 and k(k+1)(2k+1)/6 in f64, in index_closed_forms' order (the
// halving as a product by 0.5, which rounds as the division by 2 does).
__device__ __forceinline__ double sx_of(double k) {
  return __dmul_rn(__dmul_rn(k, __dadd_rn(k, 1.0)), 0.5);
}
__device__ __forceinline__ double sxx_of(double k) {
  return __ddiv_rn(__dmul_rn(__dmul_rn(k, __dadd_rn(k, 1.0)),
                             __dadd_rn(__dmul_rn(2.0, k), 1.0)),
                   6.0);
}

__global__ void __launch_bounds__(kMaxThreads)
changepoint_kernel(const float* __restrict__ values,
                   const int* __restrict__ starts,
                   const int* __restrict__ lengths, int rows, int dense_n,
                   int omega, float* __restrict__ sse, int* __restrict__ t,
                   float* __restrict__ scratch, int buf_floats) {
  extern __shared__ float smem[];
  __shared__ float sv[32];
  __shared__ int si[32];
  float* buf = scratch != nullptr
                   ? scratch + static_cast<size_t>(blockIdx.x) * buf_floats
                   : smem;
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    const size_t start = starts != nullptr
                             ? static_cast<size_t>(starts[r])
                             : static_cast<size_t>(r) * dense_n;
    const int n = starts != nullptr ? lengths[r] : dense_n;
    const float* y = values + start;
    const Levels lv = levels_of(n);
    const Chans s0 = chans(buf, lv, 0);

    // 1. centre and stage z (zeros past n fill the last 16-block).
    const float ymid = y[(n - 1) / 2];
    for (int i = tid; i < lv.nb[0] * kScanBlock; i += nt)
      s0.c[0][padded(i)] = i < n ? rn_sub(y[i], ymid) : 0.0f;
    __syncthreads();

    // 2. the three prefix sums in XLA's order (common.cuh).
    xla_scan3(buf, lv, tid, nt);
    const ScanView scan = scan_view(buf, lv);
    float tot[3];
    prefix3(scan, n - 1, tot);

    // 3-4. closed forms, SSE, mask, landscape, argmin.
    const float nf = static_cast<float>(n);
    const float lo = static_cast<float>(omega);
    const float hi = rn_sub(nf, static_cast<float>(omega));
    const double nd = static_cast<double>(n);
    const double sx_tot = sx_of(nd), sxx_tot = sxx_of(nd);
    float best = inf_f();
    int best_i = INT_MAX;
    for (int i = tid; i < n; i += nt) {
      float cs[3];
      prefix3(scan, i, cs);
      const float k = static_cast<float>(i + 1);
      const double kd = static_cast<double>(i + 1);
      const double sx1d = sx_of(kd), sxx1d = sxx_of(kd);
      const float sx1 = __double2float_rn(sx1d);
      const float sxx1 = __double2float_rn(sxx1d);
      const float sx2 = __double2float_rn(__dsub_rn(sx_tot, sx1d));
      const float sxx2 = __double2float_rn(__dsub_rn(sxx_tot, sxx1d));
      const float s1 = seg_sse(k, sx1, cs[0], sxx1, cs[2], cs[1]);
      const float s2 =
          seg_sse(rn_sub(nf, k), sx2, rn_sub(tot[0], cs[0]), sxx2,
                  rn_sub(tot[2], cs[2]), rn_sub(tot[1], cs[1]));
      const float v = (k >= lo && k <= hi) ? rn_add(s1, s2) : inf_f();
      if (sse != nullptr) sse[start + i] = v;
      if (v < best) {  // i ascends per thread: keeps the first minimum
        best = v;
        best_i = i;
      }
    }
    const int win = block_argmin(best, best_i, sv, si);  // ends synced
    if (tid == 0) t[r] = (win == INT_MAX ? 0 : win) + 1;
  }
}

}  // namespace
}  // namespace repro_torch

// t[r] = argmin + 1 of the two-segment SSE landscape of each sorted row.
//
// Rows: row r is values[starts[r] .. starts[r] + lengths[r]) (int32), or,
// when starts is null, the dense row values[r * dense_n .. (r+1) * dense_n).
// lmax is the longest row.  sse: null, or an output in the layout of values
// (sse[starts[r] + i] for k = i + 1; positions no row covers are left
// unwritten).  scratch: null for the shared-memory route (buf_floats, the
// scan floats of an lmax row, must be at most kSharedFloats), else
// `blocks` slices of buf_floats floats each, one per block of a grid of
// `blocks`.  Everything on the stream's device, contiguous.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int changepoint_scan(const float* values, const int* starts,
                                const int* lengths, int rows, int dense_n,
                                int lmax, int omega, float* sse, int* t,
                                float* scratch, int blocks, int buf_floats,
                                cudaStream_t stream) {
  using namespace repro_torch;
  if (rows <= 0 || lmax <= 0 || buf_floats <= 0 ||
      (starts == nullptr && dense_n != lmax) ||
      (starts != nullptr && lengths == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // One warp per 256 elements of the longest row, 1 to 32 warps: at the
  // job's 1000-point rows 4 warps let all 1024 blocks be resident at once.
  const int warps = (lmax + 255) / 256;
  const int threads = 32 * (warps < kMaxThreads / 32 ? warps : kMaxThreads / 32);
  size_t smem = 0;
  int grid = rows;
  if (scratch == nullptr) {
    if (buf_floats > kSharedFloats)
      return static_cast<int>(cudaErrorInvalidValue);
    smem = static_cast<size_t>(buf_floats) * sizeof(float);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          changepoint_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
  } else {
    if (blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
    grid = rows < blocks ? rows : blocks;
  }
  changepoint_kernel<<<grid, threads, smem, stream>>>(
      values, starts, lengths, rows, dense_n, omega, sse, t, scratch,
      buf_floats);
  return static_cast<int>(cudaGetLastError());
}
