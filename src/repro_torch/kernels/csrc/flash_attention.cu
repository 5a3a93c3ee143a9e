// Causal / sliding-window GQA flash attention on Hopper's tensor cores
// (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::flash_attention
// (the Pallas body _kernel), whose grid (B, H, nQ, nK) runs the key axis in
// sequence and carries the online-softmax m, l and acc in VMEM scratch.
//
// The function.  o[b, q, h] = softmax_k(scale q.k) v over the keys a query
// may see: k < S, causal: k <= q, window > 0: q - k < window; query head h
// reads KV head h / (H / KH).  q and o are (B, S, H, D), k and v
// (B, S, KH, D), all in the entry's type; D is any multiple of 8 up to 128
// for the two tensor-core entries below and up to 256 for the wide entries
// (flash_wide_kernel, after them).
// The softmax runs online in f32 with the scale folded into base 2
// (2^x of s * scale * log2 e); a row with nothing live yet uses 0 as its
// base, so exp never sees -inf - -inf and a fully masked row gives 0.
//
// What bounds it on an H100: operations.  Each live (query, key) pair costs
// 4 D operations (q.k and p v) against 2 D elements of K and V that a
// query tile shares; at the serve shape of h2o-danube-3-4b (B = 2,
// S = 7168, H = 32, KH = 8, D = 120, window 4096) a launch does 644 GFLOP
// on 550 MB, far above the ~300 operations per byte where the tensor cores
// become the limit: 0.65 ms in bf16 (989 TFLOP/s), 3.9 ms in f32 carried
// as three TF32 products (495 / 3 TFLOP/s).
//
// Both entries keep the work to the live tiles: a block owns one query
// tile of (b, h) and walks only the key tiles from the one holding
// q0 - window + 1 (window > 0) to, when causal, the one holding its last
// query (the dead-block test of kernel.py:75-80 as loop bounds), so
// sliding-window attention costs O(S * window).  The mask arithmetic runs
// only on tiles that cross the diagonal, the window's edge or S.  Blocks
// run the query tiles last-first (the widest spans start early) and the
// H / KH query heads that share a KV head side by side, so their K and V
// tiles are read from L2.
//
// bf16 entry (flash_wgmma_bf16): 288 threads, 128 query rows.
//   * Tensor cores: two consumer warpgroups own 64 query rows each.
//     S = Q K^T is wgmma m64n128k16 with both operands in shared memory;
//     P, rounded to bf16, becomes the A fragment of the P V wgmma straight
//     from the S accumulator's registers (the two layouts coincide), and V
//     is the MN-major B operand, so P never goes through shared memory.
//   * Overlap: one producer warp keeps TMA loads (cp.async.bulk.tensor) of
//     128-key K and V tiles in flight into a two-stage ring guarded by
//     mbarriers (full: bytes landed; empty: both warpgroups done), so the
//     next tile's copy runs under this tile's products; Q arrives once by
//     TMA.  No __syncthreads in the loop.
//   * Tiles and D: every tile is 128 rows by two 64-column panels of 128
//     bytes under the 128-byte swizzle that wgmma reads.  The tensor maps
//     are (D, heads, S, B) with a box of one head and one batch, so columns
//     past D and rows past S fill with zeros inside the batch: D = 120 is
//     padded to 128 and a ragged S is cut by TMA, the host pads nothing.
//     Shared memory: Q 32 KiB + 2 stages x (K 32 + V 32 KiB) = 160 KiB.
//
// f32 entry (flash_wgmma_tf32): 256 threads, 64 query rows, 32-key tiles.
//   * Tensor cores at f32 accuracy (3xTF32): each operand x is split into
//     big = tf32_rna(x) and small = tf32_rna(x - big), and small.big +
//     big.small + big.big goes into the f32 accumulator, for Q K^T and for
//     P V; one TF32 pass keeps ~3 digits and misses the f32 tolerance.
//     wgmma (m64n32k8 for S, m64n128k8 for P V) and not mma.sync: an
//     mma.sync kernel of the same split, eight consumer warps under the
//     168-register cap of twelve warps, took 1.56-1.66x the time on an
//     H100 at full size.  wgmma's tf32 form takes only K-major operands,
//     so V is stored transposed.
//   * Overlap: a splitting warpgroup loads each K and V tile, splits it
//     once into big and small copies (V transposed) in the swizzled layout
//     wgmma reads, and signals an mbarrier; the consumer warpgroup's
//     products run from those copies while the next tile is loaded and
//     split (two stages).  Q is split once per block.  P stays in
//     registers as the A operand of P V: the keys of each 8 are stored in
//     V^T in the order P's registers give them.  Each tile's P V products
//     sum into a zeroed partial added to the output in IEEE f32, so the
//     error does not grow with the keys (the tensor cores' own f32
//     accumulation drifts with the number of products it takes).
//   * Shared memory: 64 KiB of Q copies + 2 stages x 64 KiB of K and V^T
//     copies = 192 KiB.

// CUtensorMap's types; the encoder itself is looked up in libcuda at run time
#include <cuda.h>
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kFaMaxDim = 128;  // largest head dimension
constexpr float kLog2e = 1.4426950408889634f;

// Keys [k0, k0 + bn) of query rows [qr0, qr0 + rows): does any pair need a
// mask (past S, after the query, or out of the window)?
__device__ __forceinline__ bool crosses_mask(int k0, int bn, int qr0,
                                             int rows, int S, int causal,
                                             int window) {
  return k0 + bn > S || (causal && k0 + bn - 1 > qr0) ||
         (window > 0 && qr0 + rows - 1 - k0 >= window);
}

__device__ __forceinline__ bool live(int qpos, int kpos, int S, int causal,
                                     int window) {
  return kpos < S && (!causal || qpos >= kpos) &&
         (window == 0 || qpos - kpos < window);
}

// 2^x in one MUFU.EX2 (relative error ~2^-22; subnormal results flush to
// 0, and 2^-inf = 0).  exp2f adds range handling around the same
// instruction, which costs the bf16 kernel 5-7% of its time on an H100 and
// buys no accuracy at these tolerances.
__device__ __forceinline__ float exp2_(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One online-softmax step for R rows whose scores (already in base-2
// units, masked entries -inf) lie in x[r][0 .. N) of this thread and of
// the three other threads of its quad.  Returns each row's rescale
// factor in alpha; x becomes p; l gathers this thread's share of the sums.
template <int R, int N>
__device__ __forceinline__ void softmax_step(float (&x)[R][N], float (&m)[R],
                                             float (&l)[R],
                                             float (&alpha)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float mx = -inf_f();
#pragma unroll
    for (int i = 0; i < N; ++i) mx = fmaxf(mx, x[r][i]);
    mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(kFullMask, mx, 2));
    const float mn = fmaxf(m[r], mx);
    const float base = mn == -inf_f() ? 0.0f : mn;
    alpha[r] = exp2_(m[r] - base);
    m[r] = mn;
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      x[r][i] = exp2_(x[r][i] - base);
      sum += x[r][i];
    }
    l[r] = l[r] * alpha[r] + sum;
  }
}

// Sum of a row's l over its quad, as 1 / l (0 for a row with no live key).
__device__ __forceinline__ float inv_rowsum(float l) {
  l += __shfl_xor_sync(kFullMask, l, 1);
  l += __shfl_xor_sync(kFullMask, l, 2);
  return l > 0.0f ? 1.0f / l : 0.0f;
}

// Block index -> (query tile, head, batch): the H / KH heads of one KV head
// fastest, then the query tiles last-first, then the KV heads, then batch.
struct BlockPos {
  int iq, h, kvh, b;
};
__device__ __forceinline__ BlockPos block_pos(int nq, int H, int KH) {
  const int group = H / KH;
  int id = static_cast<int>(blockIdx.x);
  BlockPos p;
  const int g = id % group;
  id /= group;
  p.iq = nq - 1 - id % nq;
  id /= nq;
  p.kvh = id % KH;
  p.b = id / KH;
  p.h = p.kvh * group + g;
  return p;
}

// ======================================================= bf16: wgmma + TMA
constexpr int kBm = 128;                        // query rows per block
constexpr int kBn = 128;                        // keys per K / V tile
constexpr int kPanelBytes = 128 * 128;          // 128 rows x 64 bf16
constexpr int kTileBytes = 2 * kPanelBytes;     // D padded to 128
constexpr int kWgThreads = 128;
constexpr int kBf16Threads = 2 * kWgThreads + 32;  // + one producer warp
// Q, then K of stages 0-1, then V of stages 0-1, then 5 mbarriers; 1 KiB
// of slack aligns the tiles to the 1,024 bytes the swizzle repeats over.
// kBm and kBf16Smem are copied in flash_attention/ops.py (_BLOCK); a test
// evaluates these constexpr lines and holds the copy to them.
constexpr int kBarOffset = 5 * kTileBytes;
constexpr size_t kBf16Smem = kBarOffset + 5 * 8 + 1024;

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}
// Waits until the phase of parity `parity` has completed.  A wait that
// never ends (a copy that cannot land) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (long long spin = 0; !done; ++spin) {
    if (spin == (1ll << 28)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box (64 columns x 1 head x 128 rows x 1 batch) of a 4-d tensor map
// into shared memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(head),
      "r"(row), "r"(batch)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous wgmma that owns it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define FA_ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define FA_ACC16(i) FA_ACC4(i), FA_ACC4(i + 4), FA_ACC4(i + 8), FA_ACC4(i + 12)
#define FA_ACC64 FA_ACC16(0), FA_ACC16(16), FA_ACC16(32), FA_ACC16(48)
#define FA_REGS64                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// d (64 x 128, f32) (+)= A (64 x 16, K-major in shared memory) B (16 x 128,
// K-major in shared memory); accumulate unless scale_d == 0.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FA_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : FA_ACC64
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 128, f32) += A (64 x 16, bf16 fragments in registers) B (16 x
// 128, MN-major in shared memory).
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " FA_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : FA_ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__global__ void __launch_bounds__(kBf16Threads, 1)
flash_wgmma_bf16(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 __nv_bfloat16* __restrict__ o, int S, int H, int KH, int D,
                 int causal, int window, float sl2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = base + kTileBytes;      // + stage * kTileBytes
  const uint32_t v_s = base + 3 * kTileBytes;  // + stage * kTileBytes
  const uint32_t bar = base + kBarOffset;      // full 0-1, empty 0-1, q
  const uint32_t full0 = bar, empty0 = bar + 16, qfull = bar + 32;

  const int nq = (S + kBm - 1) / kBm;
  const BlockPos bp = block_pos(nq, H, KH);
  const int q0 = bp.iq * kBm;
  const int q_last = min(q0 + kBm, S) - 1;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_last = causal ? q_last : S - 1;
  const int t_first = k_first / kBn;
  const int ntiles = k_last / kBn - t_first + 1;

  if (threadIdx.x == 0) {
    mbar_init(full0, 1);
    mbar_init(full0 + 8, 1);
    mbar_init(empty0, 2 * kWgThreads);
    mbar_init(empty0 + 8, 2 * kWgThreads);
    mbar_init(qfull, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 2 * kWgThreads) {
    // ---- producer warp: Q once, then K and V tiles through the ring ----
    if (threadIdx.x == 2 * kWgThreads) {
      mbar_expect_tx(qfull, kTileBytes);
      tma_load(q_s, &qmap, qfull, 0, bp.h, q0, bp.b);
      tma_load(q_s + kPanelBytes, &qmap, qfull, 64, bp.h, q0, bp.b);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i & 1;
        mbar_wait(empty0 + 8 * s, ((i >> 1) & 1) ^ 1);
        const int k0 = (t_first + i) * kBn;
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, 2 * kTileBytes);
        const uint32_t ks = k_s + s * kTileBytes, vs = v_s + s * kTileBytes;
        tma_load(ks, &kmap, full, 0, bp.kvh, k0, bp.b);
        tma_load(ks + kPanelBytes, &kmap, full, 64, bp.kvh, k0, bp.b);
        tma_load(vs, &vmap, full, 0, bp.kvh, k0, bp.b);
        tma_load(vs + kPanelBytes, &vmap, full, 64, bp.kvh, k0, bp.b);
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each ----------------------------
  const int wg = threadIdx.x / kWgThreads;
  const int t = threadIdx.x % kWgThreads;
  const int lane = t & 31;
  const int qw0 = q0 + 64 * wg;                    // first row of the group
  const int qa = qw0 + 16 * (t >> 5) + (lane >> 2);  // rows qa and qa + 8
  const int c0 = 2 * (lane & 3);                   // columns c0, c0 + 1 of
                                                   // each 8-column block
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  float m[2] = {-inf_f(), -inf_f()}, l[2] = {0.0f, 0.0f};

  mbar_wait(qfull, 0);
  const uint32_t q_wg = q_s + 64 * 128 * wg;  // this group's 64 rows
  for (int i = 0; i < ntiles; ++i) {
    const int s = i & 1;
    const int k0 = (t_first + i) * kBn;
    mbar_wait(full0 + 8 * s, (i >> 1) & 1);
    const uint32_t ks = k_s + s * kTileBytes, vs = v_s + s * kTileBytes;

    // S = Q K^T over D padded to 128: 8 steps of 16, 32 bytes into a panel
    float sc[64];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t off = (kk >> 2) * kPanelBytes + (kk & 3) * 32;
      wgmma_ss(sc, sw128_desc(q_wg + off, 16, 1024),
               sw128_desc(ks + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // accumulator layout: sc[4j + e] is row qa + 8 (e >> 1), key
    // k0 + 8 j + c0 + (e & 1)
    float x[2][32];
    const bool edge = crosses_mask(k0, kBn, qw0, 64, S, causal, window);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = sc[4 * j + e] * sl2;
        if (edge && !live(qa + 8 * (e >> 1), k0 + 8 * j + c0 + (e & 1), S,
                          causal, window))
          val = -inf_f();
        x[e >> 1][2 * j + (e & 1)] = val;
      }
    float alpha[2];
    softmax_step(x, m, l, alpha);
#pragma unroll
    for (int i2 = 0; i2 < 64; ++i2) acc[i2] *= alpha[(i2 >> 1) & 1];

    // P as the A fragments of P V: keys 16 kk .. 16 kk + 15 are the
    // accumulator's column blocks 2 kk and 2 kk + 1.
    uint32_t pa[8][4];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      pa[kk][0] = pack_bf16(x[0][4 * kk], x[0][4 * kk + 1]);
      pa[kk][1] = pack_bf16(x[1][4 * kk], x[1][4 * kk + 1]);
      pa[kk][2] = pack_bf16(x[0][4 * kk + 2], x[0][4 * kk + 3]);
      pa[kk][3] = pack_bf16(x[1][4 * kk + 2], x[1][4 * kk + 3]);
    }
    // acc += P V: V is MN-major, its two 64-column panels kPanelBytes apart
    // (leading offset), 8-key row groups 1,024 bytes apart (stride offset)
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_rs(acc, pa[kk], sw128_desc(vs + kk * 16 * 128, kPanelBytes, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(empty0 + 8 * s);
  }

  // ---- epilogue: o = acc / l, columns past D dropped ----------------------
  const float inv[2] = {inv_rowsum(l[0]), inv_rowsum(l[1])};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = qa + 8 * r;
    if (qpos >= S) continue;
    __nv_bfloat16* row =
        o + ((static_cast<size_t>(bp.b) * S + qpos) * H + bp.h) * D;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + c0;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(row + col) = __floats2bfloat162_rn(
            acc[4 * j + 2 * r] * inv[r], acc[4 * j + 2 * r + 1] * inv[r]);
    }
  }
}


// ================================================= f32: 3xTF32 on wgmma
// Every tile holds f32 (TF32) values in 128-byte rows under the 128-byte
// swizzle that wgmma reads, D padded to 128 as four 32-column panels: the
// big and the small copy of Q (64 rows) and, per stage, of K (32 rows)
// and of V^T (128 rows of 32 keys).  Then 5 mbarriers, and 1 KiB of slack
// to align the tiles to 1,024 bytes.
constexpr int kF32Bm = 64;                   // query rows: one warpgroup
constexpr int kF32Bn = 32;                   // keys per tile
constexpr int kF32Threads = 256;             // + the splitting warpgroup
constexpr int kF32QPanel = kF32Bm * 128;
constexpr int kF32QBytes = 4 * kF32QPanel;
constexpr int kF32KPanel = kF32Bn * 128;
constexpr int kF32KBytes = 4 * kF32KPanel;
constexpr int kF32VBytes = 128 * 128;
constexpr int kF32Stage = 2 * kF32KBytes + 2 * kF32VBytes;
constexpr int kF32BarOffset = 2 * kF32QBytes + 2 * kF32Stage;
// Copied with kF32Bm in flash_attention/ops.py (_BLOCK), as kBf16Smem is.
constexpr size_t kF32Smem = kF32BarOffset + 5 * 8 + 1024;

// Byte offset of 16-byte chunk `chunk` of row `row` in 128-byte swizzled rows.
__device__ __forceinline__ uint32_t sw128(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

#define FA_REGS16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

// d (64 x 32, f32) (+)= A (64 x 8) B (8 x 32), both TF32 and K-major in
// shared memory; accumulate unless scale_d == 0.
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[16], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " FA_REGS16
      ", %16, %17, p, 1, 1;\n"
      "}\n"
      : FA_ACC16(0)
      : "l"(da), "l"(db), "r"(scale_d));
}
// d (64 x 128, f32) (+)= A (64 x 8, TF32 fragments in registers) B (8 x
// 128, K-major in shared memory); accumulate unless scale_d == 0.
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " FA_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : FA_ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
__device__ __forceinline__ void st_shared4(uint32_t addr, uint32_t a,
                                           uint32_t b, uint32_t c,
                                           uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}
__device__ __forceinline__ void st_shared1(uint32_t addr, uint32_t a) {
  asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr), "r"(a) : "memory");
}
// Four values of one row, split, into the big and the small copy.
__device__ __forceinline__ void st_split4(uint32_t big, uint32_t small,
                                          float4 x) {
  uint32_t b[4], s[4];
  split_tf32(x.x, b[0], s[0]);
  split_tf32(x.y, b[1], s[1]);
  split_tf32(x.z, b[2], s[2]);
  split_tf32(x.w, b[3], s[3]);
  st_shared4(big, b[0], b[1], b[2], b[3]);
  st_shared4(small, s[0], s[1], s[2], s[3]);
}

__global__ void __launch_bounds__(kF32Threads, 1)
flash_wgmma_tf32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S,
                 int H, int KH, int D, int causal, int window, float sl2) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t qb = base, qsm = base + kF32QBytes;
  const uint32_t st0 = base + 2 * kF32QBytes;  // + s * kF32Stage: stage s
  const uint32_t bar = base + kF32BarOffset;
  const uint32_t full0 = bar, empty0 = bar + 16, qfull = bar + 32;

  const int nq = (S + kF32Bm - 1) / kF32Bm;
  const BlockPos bp = block_pos(nq, H, KH);
  const int q0 = bp.iq * kF32Bm;
  const int q_last = min(q0 + kF32Bm, S) - 1;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_last = causal ? q_last : S - 1;
  const int t_first = k_first / kF32Bn;
  const int ntiles = k_last / kF32Bn - t_first + 1;

  if (threadIdx.x == 0) {
    mbar_init(full0, 128);
    mbar_init(full0 + 8, 128);
    mbar_init(empty0, 128);
    mbar_init(empty0 + 8, 128);
    mbar_init(qfull, 128);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- splitting warpgroup ---------------------------------------------
    const int st = threadIdx.x - 128;
    for (int i = st; i < kF32Bm * 32; i += 128) {
      const int r = i >> 5, c4 = i & 31, d0 = 4 * c4;
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (d0 < D && q0 + r < S)
        x = *reinterpret_cast<const float4*>(
            q + ((static_cast<size_t>(bp.b) * S + q0 + r) * H + bp.h) * D +
            d0);
      const uint32_t off = (c4 >> 3) * kF32QPanel + sw128(r, c4 & 7);
      st_split4(qb + off, qsm + off, x);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_arrive(qfull);
    for (int i = 0; i < ntiles; ++i) {
      const int s = i & 1;
      const int k0 = (t_first + i) * kF32Bn;
      float4 kr[8], vr[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = st + 128 * u;
        // K: a warp takes one key row; V: a warp takes 32 keys of one chunk
        const int rk = e >> 5, ck = e & 31, rv = e & 31, cv = e >> 5;
        kr[u] = vr[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (4 * ck < D && k0 + rk < S)
          kr[u] = *reinterpret_cast<const float4*>(
              k + ((static_cast<size_t>(bp.b) * S + k0 + rk) * KH + bp.kvh) *
                      D +
              4 * ck);
        if (4 * cv < D && k0 + rv < S)
          vr[u] = *reinterpret_cast<const float4*>(
              v + ((static_cast<size_t>(bp.b) * S + k0 + rv) * KH + bp.kvh) *
                      D +
              4 * cv);
      }
      mbar_wait(empty0 + 8 * s, ((i >> 1) & 1) ^ 1);
      const uint32_t kb = st0 + s * kF32Stage, ksm = kb + kF32KBytes;
      const uint32_t vb = ksm + kF32KBytes, vsm = vb + kF32VBytes;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int e = st + 128 * u;
        const int rk = e >> 5, ck = e & 31, rv = e & 31, cv = e >> 5;
        const uint32_t off = (ck >> 3) * kF32KPanel + sw128(rk, ck & 7);
        st_split4(kb + off, ksm + off, kr[u]);
        // V^T row d holds the tile's keys; within 8 keys, even keys first:
        // the order in which P's registers give them (see below)
        const int p = (rv & ~7) | ((rv & 1) << 2) | ((rv & 7) >> 1);
        const float vals[4] = {vr[u].x, vr[u].y, vr[u].z, vr[u].w};
#pragma unroll
        for (int e4 = 0; e4 < 4; ++e4) {
          uint32_t big, small;
          split_tf32(vals[e4], big, small);
          const uint32_t at = sw128(4 * cv + e4, p >> 2) + 4 * (p & 3);
          st_shared1(vb + at, big);
          st_shared1(vsm + at, small);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive(full0 + 8 * s);
    }
    return;
  }

  // ---- consumer warpgroup: 64 query rows ----------------------------------
  const int lane = threadIdx.x & 31;
  const int tq = lane & 3;
  const int qa = q0 + 16 * (threadIdx.x >> 5) + (lane >> 2);  // and qa + 8
  const int nkk = D >> 3;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  float m[2] = {-inf_f(), -inf_f()}, l[2] = {0.0f, 0.0f};

  mbar_wait(qfull, 0);
  for (int i = 0; i < ntiles; ++i) {
    const int s = i & 1;
    const int k0 = (t_first + i) * kF32Bn;
    mbar_wait(full0 + 8 * s, (i >> 1) & 1);
    const uint32_t kb = st0 + s * kF32Stage, ksm = kb + kF32KBytes;
    const uint32_t vb = ksm + kF32KBytes, vsm = vb + kF32VBytes;

    float sc[16];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kFaMaxDim / 8; ++kk) {
      if (kk < nkk) {
        const uint32_t oq = (kk >> 2) * kF32QPanel + (kk & 3) * 32;
        const uint32_t ok = (kk >> 2) * kF32KPanel + (kk & 3) * 32;
        wgmma_tf32_ss(sc, sw128_desc(qsm + oq, 16, 1024),
                      sw128_desc(kb + ok, 16, 1024), kk > 0);
        wgmma_tf32_ss(sc, sw128_desc(qb + oq, 16, 1024),
                      sw128_desc(ksm + ok, 16, 1024), 1);
        wgmma_tf32_ss(sc, sw128_desc(qb + oq, 16, 1024),
                      sw128_desc(kb + ok, 16, 1024), 1);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    float x[2][8];
    const bool edge = crosses_mask(k0, kF32Bn, q0, kF32Bm, S, causal, window);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = sc[4 * n + e] * sl2;
        if (edge && !live(qa + 8 * (e >> 1), k0 + 8 * n + 2 * tq + (e & 1), S,
                          causal, window))
          val = -inf_f();
        x[e >> 1][2 * n + (e & 1)] = val;
      }
    float alpha[2];
    softmax_step(x, m, l, alpha);

    // P's A fragments: keys 2 tq and 2 tq + 1 of each 8 play k = tq and
    // tq + 4, the order in which V^T holds them
    uint32_t pb[4][4], ps[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      split_tf32(x[0][2 * j], pb[j][0], ps[j][0]);
      split_tf32(x[1][2 * j], pb[j][1], ps[j][1]);
      split_tf32(x[0][2 * j + 1], pb[j][2], ps[j][2]);
      split_tf32(x[1][2 * j + 1], pb[j][3], ps[j][3]);
    }
    float pt[64];
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wgmma_tf32_rs(pt, ps[j], sw128_desc(vb + 32 * j, 16, 1024), j > 0);
      wgmma_tf32_rs(pt, pb[j], sw128_desc(vsm + 32 * j, 16, 1024), 1);
      wgmma_tf32_rs(pt, pb[j], sw128_desc(vb + 32 * j, 16, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(pt);
#pragma unroll
    for (int r = 0; r < 64; ++r)
      acc[r] = fmaf(acc[r], alpha[(r >> 1) & 1], pt[r]);
    mbar_arrive(empty0 + 8 * s);
  }

  const float inv[2] = {inv_rowsum(l[0]), inv_rowsum(l[1])};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = qa + 8 * r;
    if (qpos >= S) continue;
    float* row = o + ((static_cast<size_t>(bp.b) * S + qpos) * H + bp.h) * D;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = 8 * j + 2 * tq;
      if (col < D)
        *reinterpret_cast<float2*>(row + col) = make_float2(
            acc[4 * j + 2 * r] * inv[r], acc[4 * j + 2 * r + 1] * inv[r]);
    }
  }
}


#undef FA_ACC4
#undef FA_ACC16
#undef FA_ACC64
#undef FA_REGS64
#undef FA_REGS16

// ============================================ wide head dimensions: SIMT f32
// flash_wide_kernel<T> takes what the two entries above cannot: D from 136
// to 256 (DeepSeek-V2's MLA prefill has query and key heads of 192).  The
// same function, masks, dead-block loop bounds, block order and base-2
// online softmax as the wgmma entries; the TPU kernel it serves is the same
// (flash_attention/kernel.py:94, whose BlockSpecs take any D).
//
// Simple on purpose: 256 threads own 64 query rows, four threads a row.
// Q (64 x D), one K tile and one V tile (32 keys x D) are converted to f32
// into shared memory (rows of D + 4 floats, so the 8 rows and 4 keys a warp
// reads at once sit in distinct banks).  For each key tile a thread forms
// 8 of its row's 32 scores on the CUDA cores in f32, the quad runs the
// online-softmax step (softmax_step), P goes through shared memory at f32,
// and each thread adds P V into D / 4 columns of its row (pairs 8 j + 2 t,
// 8 j + 2 t + 1) held in registers.  Inputs in bf16 are raised to f32 on
// load, so the bf16 entry keeps P at f32 too, and rounds only the output.
//
// What bounds it: the f32 CUDA cores (67 TFLOP/s on an H100) at best; in
// practice the shared-memory reads feeding them (about one load per two
// FMAs in P V), no tensor cores and no copy overlap.  MLA's prefill shape
// (B = 2, S = 2048, H = 16, D = 192, causal) needs 51.6 GFLOP: 0.77 ms at
// the f32 units' peak.  The card's bound for the function is lower: its
// 43.0 GFLOP (V at 128) on the tensor cores, 0.26 ms as three TF32 passes
// in f32 and 0.043 ms in bf16.  A wgmma design for D up to 256 is later
// work.
constexpr int kWideBm = 64;       // query rows per block
constexpr int kWideBn = 32;       // keys per K / V tile
constexpr int kWideThreads = 256;  // four threads a query row
constexpr int kWideMaxDim = 256;
constexpr int kWidePad = 4;       // floats after each row of Q, K and V
constexpr int kWidePStride = kWideBn + 4;  // floats per row of P

__host__ __device__ constexpr size_t wide_smem(int D) {
  return 4ull * ((kWideBm + 2 * kWideBn) * (D + kWidePad) +
                 kWideBm * kWidePStride);
}
static_assert(wide_smem(kWideMaxDim) <= 232448,
              "the wide entry's block exceeds the shared memory of an SM");

// Eight elements of a row at src (16-byte aligned) into f32 at dst.
__device__ __forceinline__ void load8(const float* src, float* dst) {
  reinterpret_cast<float4*>(dst)[0] = reinterpret_cast<const float4*>(src)[0];
  reinterpret_cast<float4*>(dst)[1] = reinterpret_cast<const float4*>(src)[1];
}
__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
}
__device__ __forceinline__ void store2(float* dst, float a, float b) {
  *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* dst, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
}

// rows x D of a (B, S, heads, D) tensor, rows from `row0`, into shared
// memory at `dst` (row stride D + kWidePad); rows past S are zero.
template <typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ src,
                                           float* dst, int rows, int row0,
                                           int b, int head, int S, int heads,
                                           int D) {
  const int per_row = D / 8;
  for (int i = threadIdx.x; i < rows * per_row; i += kWideThreads) {
    const int r = i / per_row, c = 8 * (i - r * per_row);
    float* out = dst + r * (D + kWidePad) + c;
    if (row0 + r < S) {
      load8(src + ((static_cast<size_t>(b) * S + row0 + r) * heads + head) *
                      D + c,
            out);
    } else {
      reinterpret_cast<float4*>(out)[0] = make_float4(0.f, 0.f, 0.f, 0.f);
      reinterpret_cast<float4*>(out)[1] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kWideThreads)
flash_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, int S, int H,
                  int KH, int D, int causal, int window, float sl2) {
  extern __shared__ float4 smem_wide[];
  const int ld = D + kWidePad;
  float* qs = reinterpret_cast<float*>(smem_wide);
  float* ks = qs + kWideBm * ld;
  float* vs = ks + kWideBn * ld;
  float* ps = vs + kWideBn * ld;

  const int nq = (S + kWideBm - 1) / kWideBm;
  const BlockPos bp = block_pos(nq, H, KH);
  const int q0 = bp.iq * kWideBm;
  const int q_last = min(q0 + kWideBm, S) - 1;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_last = causal ? q_last : S - 1;
  const int t_first = k_first / kWideBn;
  const int ntiles = k_last / kWideBn - t_first + 1;

  const int r = threadIdx.x >> 2, t = threadIdx.x & 3;
  const int qpos = q0 + r;
  stage_rows(q, qs, kWideBm, q0, bp.b, bp.h, S, H, D);

  float acc[kWideMaxDim / 8][2];
#pragma unroll
  for (int j = 0; j < kWideMaxDim / 8; ++j) acc[j][0] = acc[j][1] = 0.0f;
  float m[1] = {-inf_f()}, l[1] = {0.0f};

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = (t_first + it) * kWideBn;
    __syncthreads();  // the previous tile's K, V and P are read
    stage_rows(k, ks, kWideBn, k0, bp.b, bp.kvh, S, KH, D);
    stage_rows(v, vs, kWideBn, k0, bp.b, bp.kvh, S, KH, D);
    __syncthreads();

    // scores of keys t + 4 i, i < 8, against this thread's row
    float x[1][8];
#pragma unroll
    for (int i = 0; i < 8; ++i) x[0][i] = 0.0f;
    const float* qrow = qs + r * ld;
    for (int d = 0; d < D; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(qrow + d);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 kv =
            *reinterpret_cast<const float4*>(ks + (t + 4 * i) * ld + d);
        x[0][i] = fmaf(qv.x, kv.x, x[0][i]);
        x[0][i] = fmaf(qv.y, kv.y, x[0][i]);
        x[0][i] = fmaf(qv.z, kv.z, x[0][i]);
        x[0][i] = fmaf(qv.w, kv.w, x[0][i]);
      }
    }
    const bool edge =
        crosses_mask(k0, kWideBn, q0, kWideBm, S, causal, window);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      x[0][i] *= sl2;
      if (edge && !live(qpos, k0 + t + 4 * i, S, causal, window))
        x[0][i] = -inf_f();
    }
    float alpha[1];
    softmax_step(x, m, l, alpha);
#pragma unroll
    for (int i = 0; i < 8; ++i) ps[r * kWidePStride + t + 4 * i] = x[0][i];
#pragma unroll
    for (int j = 0; j < kWideMaxDim / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
    }
    __syncthreads();

    const float* prow = ps + r * kWidePStride;
    for (int kk = 0; kk < kWideBn; ++kk) {
      const float p = prow[kk];
      const float* vrow = vs + kk * ld + 2 * t;
#pragma unroll
      for (int j = 0; j < kWideMaxDim / 8; ++j) {
        if (8 * j < D) {
          const float2 vv = *reinterpret_cast<const float2*>(vrow + 8 * j);
          acc[j][0] = fmaf(p, vv.x, acc[j][0]);
          acc[j][1] = fmaf(p, vv.y, acc[j][1]);
        }
      }
    }
  }

  const float inv = inv_rowsum(l[0]);
  if (qpos >= S) return;
  T* row = o + ((static_cast<size_t>(bp.b) * S + qpos) * H + bp.h) * D;
#pragma unroll
  for (int j = 0; j < kWideMaxDim / 8; ++j)
    if (8 * j < D) store2(row + 8 * j + 2 * t, acc[j][0] * inv,
                          acc[j][1] * inv);
}

// ================================================================= host side
bool valid_shape(int batch, int S, int H, int KH, int D, int window,
                 int rows, int max_dim = kFaMaxDim) {
  if (batch <= 0 || S <= 0 || H <= 0 || KH <= 0 || H % KH || D <= 0 ||
      D % 8 || D > max_dim || window < 0)
    return false;
  const long long blocks =
      static_cast<long long>((S + rows - 1) / rows) * H * batch;
  return blocks <= 0x7fffffffLL;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in the libcuda already loaded in the
// process, so the library links against the CUDA runtime alone.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A (B, S, heads, D) bf16 tensor as 4-d map (D, heads, S, B) with a box of
// 64 columns x 1 head x 128 rows x 1 batch under the 128-byte swizzle;
// reads past D or S fill with zeros.
bool bf16_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int batch,
              int S, int heads, int D) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = 2ull * D;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * S};
  const cuuint32_t box[4] = {64, 1, kBn, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                const __nv_bfloat16* v, __nv_bfloat16* o, int batch, int S,
                int H, int KH, int D, int causal, int window, float scale,
                cudaStream_t stream) {
  static_assert(kBm == kBn, "Q and K/V tiles share one box shape");
  if (!valid_shape(batch, S, H, KH, D, window, kBm))
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap qm, km, vm;
  if (!bf16_map(enc, &qm, q, batch, S, H, D) ||
      !bf16_map(enc, &km, k, batch, S, KH, D) ||
      !bf16_map(enc, &vm, v, batch, S, KH, D))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kBf16Smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (S + kBm - 1) / kBm * H * batch;
  flash_wgmma_bf16<<<blocks, kBf16Threads, kBf16Smem, stream>>>(
      qm, km, vm, o, S, H, KH, D, causal, window, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

int launch_f32(const float* q, const float* k, const float* v, float* o,
               int batch, int S, int H, int KH, int D, int causal, int window,
               float scale, cudaStream_t stream) {
  if (!valid_shape(batch, S, H, KH, D, window, kF32Bm))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_tf32, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kF32Smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (S + kF32Bm - 1) / kF32Bm * H * batch;
  flash_wgmma_tf32<<<blocks, kF32Threads, kF32Smem, stream>>>(
      q, k, v, o, S, H, KH, D, causal, window, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_wide(const T* q, const T* k, const T* v, T* o, int batch, int S,
                int H, int KH, int D, int causal, int window, float scale,
                cudaStream_t stream) {
  if (!valid_shape(batch, S, H, KH, D, window, kWideBm, kWideMaxDim))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = wide_smem(D);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (S + kWideBm - 1) / kWideBm * H * batch;
  flash_wide_kernel<T><<<blocks, kWideThreads, smem, stream>>>(
      q, k, v, o, S, H, KH, D, causal, window, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace repro_torch

// o (B, S, H, D) = attention(q, k, v).  q and o (B, S, H, D), k and v
// (B, S, KH, D) in the entry's type, contiguous, 16-byte aligned, on the
// stream's device; H % KH == 0, D a multiple of 8 up to 128.  causal != 0
// masks keys after the query; window > 0 masks keys `window` or more
// positions before it.  Returns cudaGetLastError() after the launch (0 on
// success), or the error that kept it from launching.
extern "C" int flash_attention_f32(const float* q, const float* k,
                                   const float* v, float* o, int batch,
                                   int seqlen, int heads, int kv_heads,
                                   int headdim, int causal, int window,
                                   float scale, cudaStream_t stream) {
  return repro_torch::launch_f32(q, k, v, o, batch, seqlen, heads, kv_heads,
                                 headdim, causal, window, scale, stream);
}

extern "C" int flash_attention_bf16(const __nv_bfloat16* q,
                                    const __nv_bfloat16* k,
                                    const __nv_bfloat16* v, __nv_bfloat16* o,
                                    int batch, int seqlen, int heads,
                                    int kv_heads, int headdim, int causal,
                                    int window, float scale,
                                    cudaStream_t stream) {
  return repro_torch::launch_bf16(q, k, v, o, batch, seqlen, heads, kv_heads,
                                  headdim, causal, window, scale, stream);
}

// The same function for D a multiple of 8 up to 256, on the CUDA cores in
// f32 (flash_wide_kernel); the wrapper sends it D above 128 only.
extern "C" int flash_attention_wide_f32(const float* q, const float* k,
                                        const float* v, float* o, int batch,
                                        int seqlen, int heads, int kv_heads,
                                        int headdim, int causal, int window,
                                        float scale, cudaStream_t stream) {
  return repro_torch::launch_wide(q, k, v, o, batch, seqlen, heads, kv_heads,
                                  headdim, causal, window, scale, stream);
}

extern "C" int flash_attention_wide_bf16(const __nv_bfloat16* q,
                                         const __nv_bfloat16* k,
                                         const __nv_bfloat16* v,
                                         __nv_bfloat16* o, int batch,
                                         int seqlen, int heads, int kv_heads,
                                         int headdim, int causal, int window,
                                         float scale, cudaStream_t stream) {
  return repro_torch::launch_wide(q, k, v, o, batch, seqlen, heads, kv_heads,
                                  headdim, causal, window, scale, stream);
}
