// Causal / sliding-window GQA flash attention for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::flash_attention
// (the Pallas body _kernel), whose grid (B, H, nQ, nK) runs the key axis in
// sequence and carries the online-softmax m, l and acc in VMEM scratch.
//
// What bounds it on an H100: operations.  Each live (query, key) pair costs
// 4 D f32 operations (q.k and p v) against 2 D elements of K and V that a
// 64-row query tile shares, so at the serve shape of h2o-danube-3-4b
// (B = 2, S = 7168, H = 32, KH = 8, D = 120, window 4096) a launch does
// 644 GFLOP on 550 MB: over 1,000 operations per byte, far above the ~20
// where the f32 units (67 TFLOP/s against 3.35 TB/s) become the limit.
//
// Design.  Blocks run in parallel and in no order, so the sequential key
// axis becomes a loop inside the block: one thread block per (b, h, 64-row
// query tile) walks the live 64-row key tiles of its query tile in order.
// Only live tiles are visited: the loop starts at the tile holding
// q0 - window + 1 (window > 0) and, when causal, ends at the tile holding
// the tile's last query, the dead-block test of kernel.py:75-80 turned into
// loop bounds, so sliding-window attention costs O(S * window).  Query head
// h reads KV head h / (H / KH).  Q stays in shared memory for the whole
// loop; each step stages one K and one V tile (rows past S are zero-filled
// and their scores masked, so the host pads nothing), then:
//   1. s = (Q K^T) * scale: each of the 256 threads owns a 4 x 4 tile of
//      scores (rows ty + 16u, columns tx + 16v), read as float4 along D
//      from rows padded to D + 4 floats, so a quarter-warp's K reads hit
//      distinct banks; masked entries become -inf;
//   2. the online softmax in f32: the row max and row sum are reduced over
//      the 16 lanes that share a row with xor shuffles; m, l and the
//      rescale factor live in registers, a row with nothing live yet uses
//      0 as its base so exp never sees -inf - -inf;
//   3. P overwrites the K tile in shared memory and acc += P V, each
//      thread owning 4 rows by up to 2 float4 column chunks of D.
// Output = acc / l, written in the input type.  D may be any multiple of 8
// up to 128 (h2o-danube-3-4b has 120); a row is D / 4 float4 chunks and a
// thread takes chunks tx and tx + 16 where they exist, so no tail is
// padded.  Shared memory is 64 (D + 4) + 64 max(D + 4, 68) + 64 D floats:
// 94,208 bytes at D = 120, above the 48 KiB default (the launcher raises
// cudaFuncAttributeMaxDynamicSharedMemorySize); two blocks fit an SM.
// Query tiles run in reverse order (the last, with the widest key span,
// first) so the long blocks start early.  The grid is ceil(S / 64) * H * B
// blocks (7,168 at the serve shape).  The products run on the f32 units:
// wgmma, TMA and a bf16 tensor-core path are later work.
#include <cuda_bf16.h>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kFaThreads = 256;
constexpr int kFaTile = 64;     // query rows and key rows per tile
constexpr int kFaMaxDim = 128;  // largest head dimension
constexpr int kFaChunks = kFaMaxDim / 64;  // float4 chunks a thread owns

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<unsigned*>(&lo);
  raw.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// Stage rows p0 .. p0 + 63 of head `hh` of a (B, S, heads, D) tensor into
// shared memory as f32 rows of stride `ld`; rows at or past S are zeros.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int b, int p0, int S, int heads,
                                          int hh, int D) {
  const int nc = D >> 2;
  for (int i = threadIdx.x; i < kFaTile * nc; i += blockDim.x) {
    const int r = i / nc, c = i - r * nc;
    const int pos = p0 + r;
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (pos < S)
      val = load4(src + ((static_cast<size_t>(b) * S + pos) * heads + hh) * D
                  + 4 * c);
    *reinterpret_cast<float4*>(dst + r * ld + 4 * c) = val;
  }
}

__device__ __forceinline__ float dot4(float acc, float4 a, float4 b) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <typename T>
__global__ void __launch_bounds__(kFaThreads, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int S, int H,
             int KH, int D, int causal, int window, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = D + 4;          // padded row stride of Q and K
  const int lp = kFaTile + 4;    // row stride of P
  float* qs = smem;                                   // [64][ld]
  float* ks = qs + kFaTile * ld;                      // [64][ld]; P overlays
  float* vs = ks + kFaTile * (ld > lp ? ld : lp);     // [64][D]

  const int nq = (S + kFaTile - 1) / kFaTile;
  const int iq = nq - 1 - static_cast<int>(blockIdx.x);
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KH);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nc = D >> 2;
  const int q0 = iq * kFaTile;
  const int q_last = min(q0 + kFaTile, S) - 1;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_last = causal ? q_last : S - 1;

  load_tile(qs, ld, q, b, q0, S, H, h, D);

  float m[4], l[4], acc[4][kFaChunks][4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    m[u] = -inf_f();
    l[u] = 0.0f;
#pragma unroll
    for (int cc = 0; cc < kFaChunks; ++cc)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][cc][e] = 0.0f;
  }

  for (int t = k_first / kFaTile; t <= k_last / kFaTile; ++t) {
    const int k0 = t * kFaTile;
    __syncthreads();  // the previous step's reads of P and V are done
    load_tile(ks, ld, k, b, k0, S, KH, kvh, D);
    load_tile(vs, D, v, b, k0, S, KH, kvh, D);
    __syncthreads();

    // ---- 1. scores s = (Q K^T) * scale, masked to -inf ------------------
    float s[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int w = 0; w < 4; ++w) s[u][w] = 0.0f;
    for (int c = 0; c < nc; ++c) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        qv[u] = *reinterpret_cast<const float4*>(qs + (ty + 16 * u) * ld
                                                 + 4 * c);
        kv[u] = *reinterpret_cast<const float4*>(ks + (tx + 16 * u) * ld
                                                 + 4 * c);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int w = 0; w < 4; ++w) s[u][w] = dot4(s[u][w], qv[u], kv[w]);
    }

    // ---- 2. online softmax over the 16 lanes of each row ----------------
    float alpha[4], rsum[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int qpos = q0 + ty + 16 * u;
      float mt = -inf_f();
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int kpos = k0 + tx + 16 * w;
        bool live = kpos < S;
        if (causal) live = live && qpos >= kpos;
        if (window > 0) live = live && qpos - kpos < window;
        s[u][w] = live ? s[u][w] * scale : -inf_f();
        mt = fmaxf(mt, s[u][w]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(kFullMask, mt, off));
      const float mn = fmaxf(m[u], mt);
      const float base = mn == -inf_f() ? 0.0f : mn;
      alpha[u] = expf(m[u] - base);
      m[u] = mn;
      float rs = 0.0f;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        s[u][w] = expf(s[u][w] - base);
        rs += s[u][w];
      }
      rsum[u] = rs;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rsum[u] += __shfl_xor_sync(kFullMask, rsum[u], off);
      l[u] = l[u] * alpha[u] + rsum[u];
#pragma unroll
      for (int cc = 0; cc < kFaChunks; ++cc)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[u][cc][e] *= alpha[u];
    }

    // ---- 3. P over the K tile, then acc += P V --------------------------
    __syncthreads();  // every read of the K tile is done
    float* ps = ks;
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int w = 0; w < 4; ++w) ps[(ty + 16 * u) * lp + tx + 16 * w] = s[u][w];
    __syncthreads();
    for (int j = 0; j < kFaTile; j += 4) {
      float4 pv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        pv[u] = *reinterpret_cast<const float4*>(ps + (ty + 16 * u) * lp + j);
#pragma unroll
      for (int cc = 0; cc < kFaChunks; ++cc) {
        const int c = tx + 16 * cc;
        if (c < nc) {
          const float4 v0 = *reinterpret_cast<const float4*>(vs + j * D + 4 * c);
          const float4 v1 =
              *reinterpret_cast<const float4*>(vs + (j + 1) * D + 4 * c);
          const float4 v2 =
              *reinterpret_cast<const float4*>(vs + (j + 2) * D + 4 * c);
          const float4 v3 =
              *reinterpret_cast<const float4*>(vs + (j + 3) * D + 4 * c);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            float* a = acc[u][cc];
            a[0] = fmaf(pv[u].w, v3.x, fmaf(pv[u].z, v2.x,
                        fmaf(pv[u].y, v1.x, fmaf(pv[u].x, v0.x, a[0]))));
            a[1] = fmaf(pv[u].w, v3.y, fmaf(pv[u].z, v2.y,
                        fmaf(pv[u].y, v1.y, fmaf(pv[u].x, v0.y, a[1]))));
            a[2] = fmaf(pv[u].w, v3.z, fmaf(pv[u].z, v2.z,
                        fmaf(pv[u].y, v1.z, fmaf(pv[u].x, v0.z, a[2]))));
            a[3] = fmaf(pv[u].w, v3.w, fmaf(pv[u].z, v2.w,
                        fmaf(pv[u].y, v1.w, fmaf(pv[u].x, v0.w, a[3]))));
          }
        }
      }
    }
  }

  // ---- epilogue: o = acc / l in the input type --------------------------
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int qpos = q0 + ty + 16 * u;
    if (qpos >= S) continue;
    const float inv = l[u] > 0.0f ? 1.0f / l[u] : 0.0f;
    T* row = o + (static_cast<size_t>(b) * S + qpos) * H * D
             + static_cast<size_t>(h) * D;
#pragma unroll
    for (int cc = 0; cc < kFaChunks; ++cc) {
      const int c = tx + 16 * cc;
      if (c < nc)
        store4(row + 4 * c,
               make_float4(acc[u][cc][0] * inv, acc[u][cc][1] * inv,
                           acc[u][cc][2] * inv, acc[u][cc][3] * inv));
    }
  }
}

size_t flash_smem_bytes(int D) {
  const size_t ld = static_cast<size_t>(D) + 4;
  const size_t lp = kFaTile + 4;
  return sizeof(float) * kFaTile * (ld + (ld > lp ? ld : lp) + D);
}

template <typename T>
int launch_flash(const T* q, const T* k, const T* v, T* o, int batch, int S,
                 int H, int KH, int D, int causal, int window, float scale,
                 cudaStream_t stream) {
  if (batch <= 0 || S <= 0 || H <= 0 || KH <= 0 || H % KH || D <= 0 ||
      D % 8 || D > kFaMaxDim || window < 0 || batch > 65535 || H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = flash_smem_bytes(D);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((S + kFaTile - 1) / kFaTile, H, batch);
  flash_kernel<T><<<grid, kFaThreads, smem, stream>>>(
      q, k, v, o, S, H, KH, D, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// o (B, S, H, D) = attention(q, k, v).  q and o (B, S, H, D), k and v
// (B, S, KH, D) in the entry's type, contiguous, 16-byte aligned, on the
// stream's device; H % KH == 0, D a multiple of 8 up to 128.  causal != 0
// masks keys after the query; window > 0 masks keys `window` or more
// positions before it.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* o, int batch,
                                   int seqlen, int heads, int kv_heads,
                                   int headdim, int causal, int window,
                                   float scale, cudaStream_t stream) {
  return repro_torch::launch_flash<float>(q, k, v, o, batch, seqlen, heads,
                                          kv_heads, headdim, causal, window,
                                          scale, stream);
}

extern "C" int flash_attention_bf16(const __nv_bfloat16* q,
                                    const __nv_bfloat16* k,
                                    const __nv_bfloat16* v, __nv_bfloat16* o,
                                    int batch, int seqlen, int heads,
                                    int kv_heads, int headdim, int causal,
                                    int window, float scale,
                                    cudaStream_t stream) {
  return repro_torch::launch_flash<__nv_bfloat16>(
      q, k, v, o, batch, seqlen, heads, kv_heads, headdim, causal, window,
      scale, stream);
}
