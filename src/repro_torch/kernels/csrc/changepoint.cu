// Batched two-segment SSE scan with a fused argmin (the paper's change-point
// estimator, §4.3), for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/changepoint/kernel.py::sse_scan (the Pallas
// body _kernel), which the reference launches once per row under vmap and
// follows with jnp.argmin on the host side.
//
// What bounds it on an H100: bytes.  Per candidate k the kernel reads three
// prefix sums and four shared closed forms and writes one SSE: ~16 bytes of
// row data for ~40 f32 operations, far below the ~20 operations per byte
// where the f32 units (67 TFLOP/s against 3.35 TB/s) would become the limit.
//
// Design: one thread block per row (rows independent, nothing carried
// between blocks), threads striding over k so neighbouring threads touch
// neighbouring addresses (coalesced), the four (n,) closed forms shared by
// every row and held in L2.  The argmin is fused: each thread keeps its
// first minimum while walking k upwards, then a warp-shuffle reduction and
// one shared-memory pass pick the block's lowest-index minimum, so the
// landscape never has to be read back to choose t.  An all-inf row (no
// valid split) returns index 0, i.e. t = 1, as jnp.argmin does.
#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
sse_argmin_kernel(const float* __restrict__ cy, const float* __restrict__ cyy,
                  const float* __restrict__ cxy,
                  const float* __restrict__ totals,
                  const float* __restrict__ sx1,
                  const float* __restrict__ sxx1,
                  const float* __restrict__ sx2,
                  const float* __restrict__ sxx2, float* __restrict__ sse,
                  int* __restrict__ t, int n, int omega) {
  __shared__ float sv[32];
  __shared__ int si[32];
  const size_t base = static_cast<size_t>(blockIdx.x) * n;
  const float tot_y = totals[3 * blockIdx.x + 0];
  const float tot_yy = totals[3 * blockIdx.x + 1];
  const float tot_xy = totals[3 * blockIdx.x + 2];
  const float nf = static_cast<float>(n);
  const float lo = static_cast<float>(omega);
  const float hi = rn_sub(nf, static_cast<float>(omega));

  float best = inf_f();
  int best_i = INT_MAX;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float k = static_cast<float>(i + 1);
    const float c_y = cy[base + i], c_yy = cyy[base + i], c_xy = cxy[base + i];
    const float s1 = seg_sse(k, sx1[i], c_y, sxx1[i], c_xy, c_yy);
    const float s2 = seg_sse(rn_sub(nf, k), sx2[i], rn_sub(tot_y, c_y), sxx2[i],
                             rn_sub(tot_xy, c_xy), rn_sub(tot_yy, c_yy));
    const float v = (k >= lo && k <= hi) ? rn_add(s1, s2) : inf_f();
    sse[base + i] = v;
    if (v < best) {  // k ascends per thread: keeps the first minimum
      best = v;
      best_i = i;
    }
  }
  const int win = block_argmin(best, best_i, sv, si);
  if (threadIdx.x == 0) t[blockIdx.x] = (win == INT_MAX ? 0 : win) + 1;
}

}  // namespace
}  // namespace repro_torch

// sse[r, k-1] for every row r and candidate k, and t[r] = argmin + 1.
// Inputs: cy/cyy/cxy (rows, n) f32, totals (rows, 3) f32, sx1/sxx1/sx2/sxx2
// (n,) f32; all contiguous, on the stream's device.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int changepoint_sse_argmin(const float* cy, const float* cyy,
                                      const float* cxy, const float* totals,
                                      const float* sx1, const float* sxx1,
                                      const float* sx2, const float* sxx2,
                                      float* sse, int* t, int rows, int n,
                                      int omega, cudaStream_t stream) {
  if (rows <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  repro_torch::sse_argmin_kernel<<<rows, repro_torch::kThreads, 0, stream>>>(
      cy, cyy, cxy, totals, sx1, sxx1, sx2, sxx2, sse, t, n, omega);
  return static_cast<int>(cudaGetLastError());
}
