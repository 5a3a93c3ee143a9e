// Mamba2 SSD chunked scan (state-space duality) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/ssd/kernel.py::ssd_scan (the Pallas body
// _kernel), whose grid (B, H, chunks) runs the chunk axis in sequence and
// carries the (P, N) state in VMEM scratch.
//
// What bounds it on an H100: operations.  Per (batch, head, chunk) the scan
// does four small products (C B^T, scores X, C h^T and the state update
// (x w)^T B), about 3.7 MFLOP at C = 64, P = 64, N = 128, against 57 KiB of
// inputs and 16 KiB of output: some 60 f32 operations per byte, above the
// ~20 where the f32 units (67 TFLOP/s against 3.35 TB/s) become the limit.
//
// Design.  Blocks run in parallel and in no order, so the sequential chunk
// axis becomes a loop inside the block: one thread block per (b, h) walks
// the T/C chunks in order, and the f32 state h (P x N, 32 KiB at 64 x 128)
// never leaves shared memory.  Per chunk the block stages x (C x P), B and
// C (C x N each), dt and the scan of dt * a in shared memory; seg is a
// serial scan by one thread (C <= 64 dependent adds, rounded as the plain
// version rounds: dt * a, then the running sum).  Then three tiled passes,
// each thread owning a 4 x 4 register tile whose rows and columns are
// strided across the tile grid, so a warp reads consecutive rows of a
// padded (stride N + 1) array and hits 32 different banks:
//   1. scores[i][j] = (c_i . b_j) * exp(seg_i - seg_j) * dt_j, the exponent
//      masked to -inf above the diagonal (exp gives 0, never inf * 0);
//   2. y[i][p] = sum_j scores[i][j] x[j][p] + exp(seg_i) (c_i . h_p)
//      + d x[i][p], written in the input type;
//   3. h[p][n] = exp(seg_last) h[p][n] + sum_j x[j][p] w_j b[j][n] with
//      w_j = exp(seg_last - seg_j) dt_j, after every read of h in pass 2.
// Shared memory is (P + 2C)(N + 1) + C P + C^2 + 4C floats: 130 KiB at
// C = 64, P = 64, N = 128, above the 48 KiB default, so the launcher raises
// cudaFuncAttributeMaxDynamicSharedMemorySize; one block fits an SM.  The
// grid is B * H blocks (96 at the smoke's serve shape: under one wave of
// 132 SMs).  The products run on the f32 units, not the tensor cores:
// wgmma, TMA and TF32 are later work.
#include <cuda_bf16.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kSsdThreads = 256;
constexpr int kSsdMaxChunk = 64;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kSsdThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ a_neg, const T* __restrict__ bm,
           const T* __restrict__ cm, const float* __restrict__ dskip,
           T* __restrict__ y, int seqlen, int nheads, int P, int N, int C) {
  extern __shared__ float smem[];
  const int NP = N + 1;  // padded row stride of h, B and C
  float* hs = smem;          // [P][NP] state
  float* bs = hs + P * NP;   // [C][NP]
  float* cs = bs + C * NP;   // [C][NP]
  float* xs = cs + C * NP;   // [C][P]
  float* ss = xs + C * P;    // [C][C] scores
  float* dts = ss + C * C;   // [C]
  float* segs = dts + C;     // [C]
  float* ws = segs + C;      // [C] exp(seg_last - seg_j) * dt_j
  float* es = ws + C;        // [C] exp(seg_i)

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x;
  const float a = a_neg[h], dd = dskip[h];
  for (int i = tid; i < P * NP; i += nt) hs[i] = 0.0f;

  const int tc = C / 4, tp = P / 4, tn = N / 4;
  for (int ic = 0; ic < seqlen / C; ++ic) {
    const size_t t0 = static_cast<size_t>(b) * seqlen +
                      static_cast<size_t>(ic) * C;
    for (int i = tid; i < C * P; i += nt) {
      const int r = i / P, q = i - r * P;
      xs[i] = load_f32(x + ((t0 + r) * nheads + h) * P + q);
    }
    for (int i = tid; i < C * N; i += nt) {
      const int r = i / N, k = i - r * N;
      bs[r * NP + k] = load_f32(bm + t0 * N + i);
      cs[r * NP + k] = load_f32(cm + t0 * N + i);
    }
    for (int i = tid; i < C; i += nt) dts[i] = dt[(t0 + i) * nheads + h];
    __syncthreads();
    if (tid == 0) {
      float acc = 0.0f;
      for (int i = 0; i < C; ++i) {
        acc = rn_add(acc, rn_mul(dts[i], a));
        segs[i] = acc;
      }
    }
    __syncthreads();
    const float last = segs[C - 1];
    for (int i = tid; i < C; i += nt) {
      ws[i] = expf(last - segs[i]) * dts[i];
      es[i] = expf(segs[i]);
    }

    // ---- pass 1: scores = (C B^T) o exp(seg_i - seg_j) o dt_j, i >= j ----
    for (int tile = tid; tile < tc * tc; tile += nt) {
      const int ri = tile / tc, rj = tile - ri * tc;
      float acc[4][4] = {};
      for (int k = 0; k < N; ++k) {
        float cv[4], bv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          cv[u] = cs[(ri + u * tc) * NP + k];
          bv[u] = bs[(rj + u * tc) * NP + k];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] += cv[u] * bv[v];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int i = ri + u * tc, j = rj + v * tc;
          const float li = i >= j ? segs[i] - segs[j] : -inf_f();
          ss[i * C + j] = acc[u][v] * expf(li) * dts[j];
        }
    }
    __syncthreads();

    // ---- pass 2: y = scores X + exp(seg) (C h^T) + d X ------------------
    for (int tile = tid; tile < tc * tp; tile += nt) {
      const int ri = tile / tp, rq = tile - ri * tp;
      float yin[4][4] = {}, yout[4][4] = {};
      const int jmax = ri + 3 * tc + 1;  // scores vanish above the diagonal
      for (int j = 0; j < jmax; ++j) {
        float sv[4], xv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          sv[u] = ss[(ri + u * tc) * C + j];
          xv[u] = xs[j * P + rq + u * tp];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) yin[u][v] += sv[u] * xv[v];
      }
      for (int k = 0; k < N; ++k) {
        float cv[4], hv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          cv[u] = cs[(ri + u * tc) * NP + k];
          hv[u] = hs[(rq + u * tp) * NP + k];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) yout[u][v] += cv[u] * hv[v];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int i = ri + u * tc, q = rq + v * tp;
          const float out = yin[u][v] + es[i] * yout[u][v] + dd * xs[i * P + q];
          store_as(y + ((t0 + i) * nheads + h) * P + q, out);
        }
    }
    __syncthreads();

    // ---- pass 3: h = exp(seg_last) h + (X o w)^T B ----------------------
    const float dec = expf(last);
    for (int tile = tid; tile < tp * tn; tile += nt) {
      const int rq = tile / tn, rk = tile - rq * tn;
      float acc[4][4] = {};
      for (int j = 0; j < C; ++j) {
        const float w = ws[j];
        float xv[4], bv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          xv[u] = xs[j * P + rq + u * tp] * w;
          bv[u] = bs[j * NP + rk + u * tn];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[u][v] += xv[u] * bv[v];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          float* hp = hs + (rq + u * tp) * NP + rk + v * tn;
          *hp = *hp * dec + acc[u][v];
        }
    }
    __syncthreads();
  }
}

size_t ssd_smem_bytes(int P, int N, int C) {
  const size_t np = static_cast<size_t>(N) + 1;
  return sizeof(float) * ((static_cast<size_t>(P) + 2 * C) * np +
                          static_cast<size_t>(C) * P +
                          static_cast<size_t>(C) * C + 4 * C);
}

template <typename T>
int launch_ssd(const T* x, const float* dt, const float* a_neg, const T* b,
               const T* c, const float* d, T* y, int batch, int seqlen,
               int nheads, int P, int N, int C, cudaStream_t stream) {
  if (batch <= 0 || nheads <= 0 || C < 4 || C > kSsdMaxChunk || C % 4 ||
      P % 4 || N % 4 || P <= 0 || N <= 0 || seqlen <= 0 || seqlen % C)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = ssd_smem_bytes(P, N, C);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ssd_kernel<T><<<dim3(nheads, batch), kSsdThreads, smem, stream>>>(
      x, dt, a_neg, b, c, d, y, seqlen, nheads, P, N, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// y (B, T, H, P) = SSD(x, dt, a_neg, b, c, d).  x (B, T, H, P), b and c
// (B, T, N) in the entry's type; dt (B, T, H), a_neg = -exp(A_log) (H,) and
// d (H,) f32; all contiguous on the stream's device.  T % chunk == 0,
// chunk a multiple of 4 up to 64, P and N multiples of 4.  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int ssd_scan_f32(const float* x, const float* dt,
                            const float* a_neg, const float* b,
                            const float* c, const float* d, float* y,
                            int batch, int seqlen, int nheads, int headdim,
                            int nstate, int chunk, cudaStream_t stream) {
  return repro_torch::launch_ssd<float>(x, dt, a_neg, b, c, d, y, batch,
                                        seqlen, nheads, headdim, nstate,
                                        chunk, stream);
}

extern "C" int ssd_scan_bf16(const __nv_bfloat16* x, const float* dt,
                             const float* a_neg, const __nv_bfloat16* b,
                             const __nv_bfloat16* c, const float* d,
                             __nv_bfloat16* y, int batch, int seqlen,
                             int nheads, int headdim, int nstate, int chunk,
                             cudaStream_t stream) {
  return repro_torch::launch_ssd<__nv_bfloat16>(x, dt, a_neg, b, c, d, y,
                                                batch, seqlen, nheads,
                                                headdim, nstate, chunk,
                                                stream);
}
