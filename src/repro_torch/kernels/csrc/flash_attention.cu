// Causal / sliding-window GQA flash attention on Hopper's tensor cores
// (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention/kernel.py::flash_attention
// (the Pallas body _kernel), whose grid (B, H, nQ, nK) runs the key axis in
// sequence and carries the online-softmax m, l and acc in VMEM scratch; its
// BlockSpecs take any D.
//
// The function.  o[b, q, h] = softmax_k(scale q.k) v over the keys a query
// may see: k < S, causal: k <= q, window > 0: q - k < window; query head h
// reads KV head h / (H / KH).  q (B, S, H, D) and k (B, S, KH, D), v
// (B, S, KH, Dv) and o (B, S, H, Dv), all in the entry's type; D is a
// multiple of 8 up to 256 and Dv one up to D (DeepSeek-V2's MLA prefill
// has query and key heads of 192 and V of 128).
// The softmax runs online in f32 with the scale folded into base 2
// (2^x of s * scale * log2 e); a row with nothing live yet uses 0 as its
// base, so exp never sees -inf - -inf and a fully masked row gives 0.
//
// What bounds it on an H100: operations.  Each live (query, key) pair costs
// 2 (D + Dv) operations (q.k and p v) against D + Dv elements of K and V
// that a query tile shares; at the serve shape of h2o-danube-3-4b (B = 2,
// S = 7168, H = 32, KH = 8, D = Dv = 120, window 4096) a launch does
// 644 GFLOP on 550 MB, far above the ~300 operations per byte where the
// tensor cores become the limit: 0.65 ms in bf16 (989 TFLOP/s), 3.9 ms in
// f32 carried as three TF32 products (495 / 3 TFLOP/s).  At MLA's prefill
// shape (B = 2, S = 2048, H = KH = 16, D = 192, Dv = 128, causal) it is
// 43.0 GFLOP: 0.0434 ms in bf16, 0.260 ms in f32.
//
// Every design keeps the work to the live tiles: a block owns one query
// tile of (b, h) and walks only the key tiles from the one holding
// q0 - window + 1 (window > 0) to, when causal, the one holding its last
// query (the dead-block test of kernel.py:75-80 as loop bounds), so
// sliding-window attention costs O(S * window).  The mask arithmetic runs
// only on tiles that cross the diagonal, the window's edge or S.  Blocks
// run the query tiles last-first (the widest spans start early) and the
// H / KH query heads that share a KV head side by side, so their K and V
// tiles are read from L2.  Q and K sit in shared memory as panels of
// 128-byte rows (64 bf16 or 32 f32 columns) under the 128-byte swizzle
// that wgmma reads; the more panels D takes, the fewer keys a stage holds.
// Where V may be narrower than Q and K (the bf16 kernel and the wide f32
// one), a block also owns one panel of at most 128 V columns
// (blockIdx.y): Dv <= 128 is one panel, a wider V two, each block forming
// Q K^T anew, so the O accumulator stays at 64 registers a thread.
//
// bf16 (flash_wgmma_bf16<NP, BN>): 288 threads, 128 query rows.
//   * Tensor cores: two consumer warpgroups own 64 query rows each.
//     S = Q K^T is wgmma m64n(BN)k16 with both operands in shared memory;
//     P, rounded to bf16, becomes the A fragment of the P V wgmma straight
//     from the S accumulator's registers (the two layouts coincide), and V
//     is the MN-major B operand, so P never goes through shared memory.
//   * Overlap: one producer warp keeps TMA loads (cp.async.bulk.tensor) of
//     BN-key K and V tiles in flight into a two-stage ring guarded by
//     mbarriers (full: bytes landed; empty: both warpgroups done), so the
//     next tile's copy runs under this tile's products; Q arrives once by
//     TMA.  No __syncthreads in the loop.
//   * Tiles and D: Q and K take NP 64-column panels, V two.  The tensor
//     maps are (D or Dv, heads, S, B) with a box of one head and one
//     batch, so columns past D or Dv and rows past S fill with zeros
//     inside the batch (the padding adds 0 to the scores): D = 120 is
//     padded to 128 and D = 136 to 192, a ragged S is cut by TMA, the host
//     pads nothing.  NP = 2 (D <= 128) and NP = 3 (D <= 192) take 128-key
//     tiles, NP = 4 64: Q 16 NP KiB + 2 stages x (K 16 NP + V 32 KiB) at
//     128 keys = 160 and 208 KiB, at 64 keys 64 + 2 x (32 + 16) = 160 KiB.
//
// f32: 3xTF32 on wgmma, 256 threads, 64 query rows.
//   * Tensor cores at f32 accuracy (3xTF32): each operand x is split into
//     big = tf32_rna(x) and small = tf32_rna(x - big), and small.big +
//     big.small + big.big goes into f32, for Q K^T and for P V; one TF32
//     pass keeps ~3 digits and misses the f32 tolerance.  wgmma and not
//     mma.sync: an mma.sync kernel of the same split, eight consumer warps
//     under the 168-register cap of twelve warps, took 1.56-1.66x the time
//     on an H100 at full size.  wgmma's tf32 form takes only K-major
//     operands, so V is stored transposed.
//   * Overlap: a splitting warpgroup loads each K and V tile, splits it
//     once into big and small copies (V transposed) in the swizzled layout
//     wgmma reads, and signals an mbarrier; the consumer warpgroup's
//     products run from those copies while the next tile is loaded and
//     split.  Q is split once per block.  P stays in registers as the A
//     operand of P V: the keys of each 8 are stored in V^T in the order
//     P's registers give them.  Each tile's P V products sum into a zeroed
//     partial added to the output in IEEE f32, so the error does not grow
//     with the keys (the tensor cores' own f32 accumulation drifts with
//     the number of products it takes).
//   * D <= 128 (flash_wgmma_tf32, V as wide as D): 32-key tiles; K and
//     V^T share a two-stage ring, and Q K^T is three m64n32k8 products a
//     k-step.  Q's copies 64 KiB + 2 stages x 64 KiB = 192 KiB.
//   * D 136-256 (flash_wgmma_wide_tf32<NP, BN>, V of width Dv): Q's copies
//     alone take 96 or 128 KiB, so each K panel holds the tile's BN big
//     rows, then its BN small ones, and big.big and big.small are one
//     wgmma m64n(2 BN)k8 reading Q's big copy once, small.big one
//     m64n(BN)k8 (three separate products were slower on an H100 at
//     D = 192); K is double-buffered and freed as soon as S is formed, V^T
//     has barriers of its own and holds 32 keys: one 32-key tile or two
//     16-key tiles side by side.  NP = 6 (D <= 192) takes 32-key tiles:
//     96 KiB of Q copies + 2 x 48 KiB of K + 32 KiB of V^T = 224 KiB;
//     NP = 8 16 keys: 128 + 2 x 32 + 32 = 224 KiB.  The same design at
//     D <= 128 (NP = 4, two V^T tiles) took 1.13-1.21x the time of the one
//     above on an H100 (tools/flash_probe.py), so each keeps its side of
//     D = 128.
// The templates build each k-step's wgmma descriptor where it is used
// (desc_at), which keeps them free of spills.

// CUtensorMap's types; the encoder itself is looked up in libcuda at run time
#include <cuda.h>
#include <cuda_bf16.h>

#include <cstdint>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kFaMaxDim = 128;    // the narrow C entries' largest D
constexpr int kWideMaxDim = 256;  // the wide C entries'
constexpr int kVPanel = 128;      // V columns of one block
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
constexpr int kWgThreads = 128;
constexpr int kBf16Threads = 2 * kWgThreads + 32;  // + one producer warp
// Shared memory of the D <= 128 tiles (NP = 2, 128 keys): Q, K and V of two
// stages, each 128 rows x two 64-column panels of 128 bytes, 5 mbarriers
// and 1 KiB of alignment slack (Bf16Tiles<2, 128>::kSmem).  kBm and
// kBf16Smem are copied in flash_attention/ops.py (_BLOCK); a test
// evaluates these constexpr lines and holds the copy to them.
constexpr size_t kBf16Smem = 5 * 2 * 128 * 128 + 5 * 8 + 1024;

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

#define FA_REGS32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d (64 x 64, f32) (+)= A (64 x 16) B (16 x 64), both bf16 and K-major in
// shared memory; accumulate unless scale_d == 0.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FA_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : FA_ACC16(0), FA_ACC16(16)
      : "l"(da), "l"(db), "r"(scale_d));
}

// Descriptor d advanced by `off` bytes, formed where it is used: the empty
// asm hides d's value, so the compiler cannot hoist one descriptor per
// k-step out of the tile loop and hold them all in registers (at D = 256
// that is 128 registers, and the kernels spill).  d's 14-bit address
// field cannot carry: shared addresses stay below 2^18.
__device__ __forceinline__ uint64_t desc_at(uint64_t d, uint32_t off) {
  asm volatile("" : "+l"(d));
  return d + (off >> 4);
}

// bf16 tiles: NP 64-column panels of Q (128 rows) and K (BN rows), two
// 64-column panels of V (BN rows); Q, K of stages 0-1, V of stages 0-1,
// then 5 mbarriers, and 1 KiB of slack for the 1,024-byte alignment.
template <int NP, int BN>
struct Bf16Tiles {
  static constexpr int kQPanel = kBm * 128;
  static constexpr int kKPanel = BN * 128;
  static constexpr int kQBytes = NP * kQPanel;
  static constexpr int kKBytes = NP * kKPanel;
  static constexpr int kVBytes = 2 * kKPanel;
  static constexpr int kBarOffset = kQBytes + 2 * (kKBytes + kVBytes);
  static constexpr size_t kSmem = kBarOffset + 5 * 8 + 1024;
  static_assert(kSmem <= 232448,
                "the bf16 block exceeds the shared memory of an SM");
};
static_assert(Bf16Tiles<2, 128>::kSmem == kBf16Smem,
              "kBf16Smem is not the D <= 128 tiles' shared memory");

template <int NP, int BN>
__global__ void __launch_bounds__(kBf16Threads, 1)
flash_wgmma_bf16(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap,
                      __nv_bfloat16* __restrict__ o, int S, int H, int KH,
                      int D, int Dv, int causal, int window, float sl2) {
  using L = Bf16Tiles<NP, BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = base + L::kQBytes;     // + stage * kKBytes
  const uint32_t v_s = k_s + 2 * L::kKBytes;  // + stage * kVBytes
  const uint32_t bar = base + L::kBarOffset;  // full 0-1, empty 0-1, q
  const uint32_t full0 = bar, empty0 = bar + 16, qfull = bar + 32;

  const int nq = (S + kBm - 1) / kBm;
  const BlockPos bp = block_pos(nq, H, KH);
  const int v0 = kVPanel * static_cast<int>(blockIdx.y);  // V column
  const int q0 = bp.iq * kBm;
  const int q_last = min(q0 + kBm, S) - 1;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_last = causal ? q_last : S - 1;
  const int t_first = k_first / BN;
  const int ntiles = k_last / BN - t_first + 1;

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
      mbar_expect_tx(qfull, L::kQBytes);
#pragma unroll
      for (int p = 0; p < NP; ++p)
        tma_load(q_s + p * L::kQPanel, &qmap, qfull, 64 * p, bp.h, q0, bp.b);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i & 1;
        mbar_wait(empty0 + 8 * s, ((i >> 1) & 1) ^ 1);
        const int k0 = (t_first + i) * BN;
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, L::kKBytes + L::kVBytes);
        const uint32_t ks = k_s + s * L::kKBytes, vs = v_s + s * L::kVBytes;
#pragma unroll
        for (int p = 0; p < NP; ++p)
          tma_load(ks + p * L::kKPanel, &kmap, full, 64 * p, bp.kvh, k0,
                   bp.b);
        tma_load(vs, &vmap, full, v0, bp.kvh, k0, bp.b);
        tma_load(vs + L::kKPanel, &vmap, full, v0 + 64, bp.kvh, k0, bp.b);
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each ----------------------------
  const int wg = threadIdx.x / kWgThreads;
  const int t = threadIdx.x % kWgThreads;
  const int lane = t & 31;
  const int qw0 = q0 + 64 * wg;
  const int qa = qw0 + 16 * (t >> 5) + (lane >> 2);  // rows qa and qa + 8
  const int c0 = 2 * (lane & 3);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  float m[2] = {-inf_f(), -inf_f()}, l[2] = {0.0f, 0.0f};

  mbar_wait(qfull, 0);
  const uint32_t q_wg = q_s + 64 * 128 * wg;  // this group's rows, panel 0
  for (int i = 0; i < ntiles; ++i) {
    const int s = i & 1;
    const int k0 = (t_first + i) * BN;
    mbar_wait(full0 + 8 * s, (i >> 1) & 1);
    const uint32_t ks = k_s + s * L::kKBytes, vs = v_s + s * L::kVBytes;

    float sc[BN / 2];
    const uint64_t qd = sw128_desc(q_wg, 16, 1024);
    const uint64_t kd = sw128_desc(ks, 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NP; ++kk)
      wgmma_ss(sc, desc_at(qd, (kk >> 2) * L::kQPanel + (kk & 3) * 32),
               desc_at(kd, (kk >> 2) * L::kKPanel + (kk & 3) * 32), kk > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // sc[4j + e] is row qa + 8 (e >> 1), key k0 + 8 j + c0 + (e & 1)
    float x[2][BN / 4];
    const bool edge = crosses_mask(k0, BN, qw0, 64, S, causal, window);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
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

    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      pa[kk][0] = pack_bf16(x[0][4 * kk], x[0][4 * kk + 1]);
      pa[kk][1] = pack_bf16(x[1][4 * kk], x[1][4 * kk + 1]);
      pa[kk][2] = pack_bf16(x[0][4 * kk + 2], x[0][4 * kk + 3]);
      pa[kk][3] = pack_bf16(x[1][4 * kk + 2], x[1][4 * kk + 3]);
    }
    // acc += P V: V MN-major, its two 64-column panels kKPanel apart
    fence_regs(acc);
    const uint64_t vd = sw128_desc(vs, L::kKPanel, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_rs(acc, pa[kk], desc_at(vd, kk * 16 * 128));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(empty0 + 8 * s);
  }

  // ---- epilogue: o = acc / l, this panel's columns below Dv ---------------
  const float inv[2] = {inv_rowsum(l[0]), inv_rowsum(l[1])};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = qa + 8 * r;
    if (qpos >= S) continue;
    __nv_bfloat16* row =
        o + ((static_cast<size_t>(bp.b) * S + qpos) * H + bp.h) * Dv;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = v0 + 8 * j + c0;
      if (col < Dv)
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


// d (64 x 16, f32) (+)= A (64 x 8) B (8 x 16), both TF32 and K-major in
// shared memory; accumulate unless scale_d == 0.
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[8], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n"
      "}\n"
      : FA_ACC4(0), FA_ACC4(4)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) (+)= A (64 x 8) B (8 x 64), both TF32 and K-major in
// shared memory; accumulate unless scale_d == 0.
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " FA_REGS32
      ", %32, %33, p, 1, 1;\n"
      "}\n"
      : FA_ACC16(0), FA_ACC16(16)
      : "l"(da), "l"(db), "r"(scale_d));
}

// f32 tiles, each row 128 bytes of TF32 under the 128-byte swizzle: the
// big and the small copy of Q (64 rows x NP panels of 32 columns); per K
// stage, per panel, the tile's BN big rows, then its BN small ones; the
// big and the small V^T (128 rows of 32 keys: 32 / BN tiles, one a slot);
// 9 mbarriers and 1 KiB of alignment slack.
template <int NP, int BN>
struct WideF32 {
  static constexpr int kSlots = 32 / BN;  // V^T tiles held at once
  static constexpr int kQPanel = kF32Bm * 128;
  static constexpr int kQBytes = NP * kQPanel;
  static constexpr int kKPanel = 2 * BN * 128;
  static constexpr int kKBytes = NP * kKPanel;
  static constexpr int kVBytes = kVPanel * 128;
  static constexpr int kBarOffset = 2 * kQBytes + 2 * kKBytes + 2 * kVBytes;
  static constexpr size_t kSmem = kBarOffset + 9 * 8 + 1024;
  // a splitting thread's share of a tile: K float4 chunks, V float4 chunks
  static constexpr int kKUnits = BN * 8 * NP / 128;
  static constexpr int kVUnits = BN * 32 / 128;
  static_assert(kSmem <= 232448,
                "the wide f32 block exceeds the shared memory of an SM");
  static_assert(kKUnits * 128 == BN * 8 * NP && kSlots * BN == 32,
                "tiles the splitting warpgroup cannot cover evenly");
};

template <int NP, int BN>
__global__ void __launch_bounds__(kF32Threads, 1)
flash_wgmma_wide_tf32(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o,
                      int S, int H, int KH, int D, int Dv, int causal,
                      int window, float sl2) {
  using L = WideF32<NP, BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t qb = base, qsm = base + L::kQBytes;
  const uint32_t k_s = base + 2 * L::kQBytes;  // + s * kKBytes: stage s
  const uint32_t vb = k_s + 2 * L::kKBytes, vsm = vb + L::kVBytes;
  // K full 0-1, K empty 0-1, V full 0-1, V empty 0-1, Q
  const uint32_t bar = base + L::kBarOffset;
  const uint32_t kfull0 = bar, kempty0 = bar + 16, vfull0 = bar + 32,
                 vempty0 = bar + 48, qfull = bar + 64;

  const int nq = (S + kF32Bm - 1) / kF32Bm;
  const BlockPos bp = block_pos(nq, H, KH);
  const int v0 = kVPanel * static_cast<int>(blockIdx.y);  // V column
  const int q0 = bp.iq * kF32Bm;
  const int q_last = min(q0 + kF32Bm, S) - 1;
  const int k_first = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_last = causal ? q_last : S - 1;
  const int t_first = k_first / BN;
  const int ntiles = k_last / BN - t_first + 1;

  if (threadIdx.x == 0) {
    for (int b = 0; b < 8; ++b) mbar_init(bar + 8 * b, 128);
    mbar_init(qfull, 128);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- splitting warpgroup ---------------------------------------------
    const int st = threadIdx.x - 128;
    const int dq = D >> 2;  // float4 chunks of a Q row
    for (int i = st; i < kF32Bm * dq; i += 128) {
      const int r = i / dq, c4 = i - r * dq;
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (q0 + r < S)
        x = *reinterpret_cast<const float4*>(
            q + ((static_cast<size_t>(bp.b) * S + q0 + r) * H + bp.h) * D +
            4 * c4);
      const uint32_t off = (c4 >> 3) * L::kQPanel + sw128(r, c4 & 7);
      st_split4(qb + off, qsm + off, x);
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    mbar_arrive(qfull);
    for (int i = 0; i < ntiles; ++i) {
      const int s = i & 1, slot = i % L::kSlots;
      const int k0 = (t_first + i) * BN;
      // K: a warp takes 32 chunks of one key row; V: 32 / BN chunks of BN
      // keys
      float4 kr[L::kKUnits], vr[L::kVUnits];
#pragma unroll
      for (int u = 0; u < L::kKUnits; ++u) {
        const int e = st + 128 * u, rk = e / (8 * NP), ck = e % (8 * NP);
        kr[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (4 * ck < D && k0 + rk < S)
          kr[u] = *reinterpret_cast<const float4*>(
              k + ((static_cast<size_t>(bp.b) * S + k0 + rk) * KH + bp.kvh) *
                      D +
              4 * ck);
      }
#pragma unroll
      for (int u = 0; u < L::kVUnits; ++u) {
        const int e = st + 128 * u, rv = e % BN, col = v0 + 4 * (e / BN);
        vr[u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (col < Dv && k0 + rv < S)
          vr[u] = *reinterpret_cast<const float4*>(
              v + ((static_cast<size_t>(bp.b) * S + k0 + rv) * KH + bp.kvh) *
                      Dv +
              col);
      }
      mbar_wait(kempty0 + 8 * s, ((i >> 1) & 1) ^ 1);
      const uint32_t kb = k_s + s * L::kKBytes;
#pragma unroll
      for (int u = 0; u < L::kKUnits; ++u) {
        const int e = st + 128 * u, rk = e / (8 * NP), ck = e % (8 * NP);
        if (4 * ck < D) {
          const uint32_t off = (ck >> 3) * L::kKPanel + sw128(rk, ck & 7);
          st_split4(kb + off, kb + off + BN * 128, kr[u]);
        }
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      mbar_arrive(kfull0 + 8 * s);
      // V^T: this slot's BN keys of each row, within 8 keys even keys
      // first (the order of P's registers)
      mbar_wait(vempty0 + 8 * slot, ((i / L::kSlots) & 1) ^ 1);
#pragma unroll
      for (int u = 0; u < L::kVUnits; ++u) {
        const int e = st + 128 * u, rv = e % BN, cv = e / BN;
        const int p =
            BN * slot + ((rv & ~7) | ((rv & 1) << 2) | ((rv & 7) >> 1));
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
      mbar_arrive(vfull0 + 8 * slot);
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
  const uint64_t qbd = sw128_desc(qb, 16, 1024);
  const uint64_t qsd = sw128_desc(qsm, 16, 1024);
  const uint64_t vbd = sw128_desc(vb, 16, 1024);
  const uint64_t vsd = sw128_desc(vsm, 16, 1024);

  mbar_wait(qfull, 0);
  for (int i = 0; i < ntiles; ++i) {
    const int s = i & 1, slot = i % L::kSlots;
    const int k0 = (t_first + i) * BN;
    mbar_wait(kfull0 + 8 * s, (i >> 1) & 1);

    // sp: big.big in its first BN columns, big.small in the next BN (Q's
    // big copy read once for both); sq: small.big
    float sp[BN], sq[BN / 2];
    const uint64_t kd = sw128_desc(k_s + s * L::kKBytes, 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * NP; ++kk) {
      if (kk < nkk) {
        const uint32_t oq = (kk >> 2) * L::kQPanel + (kk & 3) * 32;
        const uint32_t ok = (kk >> 2) * L::kKPanel + (kk & 3) * 32;
        wgmma_tf32_ss(sp, desc_at(qbd, oq), desc_at(kd, ok), kk > 0);
        wgmma_tf32_ss(sq, desc_at(qsd, oq), desc_at(kd, ok), kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sp);
    fence_regs(sq);
    mbar_arrive(kempty0 + 8 * s);

    // sp[4 n + e] is row qa + 8 (e >> 1), key k0 + 8 n + 2 tq + (e & 1)
    float x[2][BN / 4];
    const bool edge = crosses_mask(k0, BN, q0, kF32Bm, S, causal, window);
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 4 * n + e;
        float val = ((sp[r + BN / 2] + sq[r]) + sp[r]) * sl2;
        if (edge && !live(qa + 8 * (e >> 1), k0 + 8 * n + 2 * tq + (e & 1), S,
                          causal, window))
          val = -inf_f();
        x[e >> 1][2 * n + (e & 1)] = val;
      }
    float alpha[2];
    softmax_step(x, m, l, alpha);

    // P's A fragments: keys 2 tq and 2 tq + 1 of each 8 play k = tq and
    // tq + 4, the order in which V^T holds them
    uint32_t pb[BN / 8][4], ps[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      split_tf32(x[0][2 * j], pb[j][0], ps[j][0]);
      split_tf32(x[1][2 * j], pb[j][1], ps[j][1]);
      split_tf32(x[0][2 * j + 1], pb[j][2], ps[j][2]);
      split_tf32(x[1][2 * j + 1], pb[j][3], ps[j][3]);
    }
    // this tile's keys sit 4 BN slot bytes into V^T's rows
    mbar_wait(vfull0 + 8 * slot, (i / L::kSlots) & 1);
    float pt[64];
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const uint32_t ov = 4 * BN * slot + 32 * j;
      wgmma_tf32_rs(pt, ps[j], desc_at(vbd, ov), j > 0);
      wgmma_tf32_rs(pt, pb[j], desc_at(vsd, ov), 1);
      wgmma_tf32_rs(pt, pb[j], desc_at(vbd, ov), 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(pt);
    mbar_arrive(vempty0 + 8 * slot);
#pragma unroll
    for (int r = 0; r < 64; ++r)
      acc[r] = fmaf(acc[r], alpha[(r >> 1) & 1], pt[r]);
  }

  const float inv[2] = {inv_rowsum(l[0]), inv_rowsum(l[1])};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = qa + 8 * r;
    if (qpos >= S) continue;
    float* row = o + ((static_cast<size_t>(bp.b) * S + qpos) * H + bp.h) * Dv;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = v0 + 8 * j + 2 * tq;
      if (col < Dv)
        *reinterpret_cast<float2*>(row + col) = make_float2(
            acc[4 * j + 2 * r] * inv[r], acc[4 * j + 2 * r + 1] * inv[r]);
    }
  }
}

#undef FA_ACC4
#undef FA_ACC16
#undef FA_ACC64
#undef FA_REGS64
#undef FA_REGS32
#undef FA_REGS16

#undef FA_ACC4
#undef FA_ACC16
#undef FA_ACC64
#undef FA_REGS64
#undef FA_REGS32
#undef FA_REGS16

// ================================================================= host side
// D and Dv multiples of 8, 0 < Dv <= D <= max_dim.
bool valid_shape(int batch, int S, int H, int KH, int D, int Dv, int window,
                 int rows, int max_dim) {
  if (batch <= 0 || S <= 0 || H <= 0 || KH <= 0 || H % KH || D <= 0 ||
      D % 8 || D > max_dim || Dv <= 0 || Dv % 8 || Dv > D || window < 0)
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
// 64 columns x 1 head x `rows` rows x 1 batch under the 128-byte swizzle;
// reads past D or S fill with zeros.
bool bf16_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int batch,
              int S, int heads, int D, int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = 2ull * D;
  const cuuint64_t strides[3] = {row, row * heads, row * heads * S};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int NP, int BN>
int launch_bf16_tiles(const __nv_bfloat16* q, const __nv_bfloat16* k,
                      const __nv_bfloat16* v, __nv_bfloat16* o, int batch,
                      int S, int H, int KH, int D, int Dv, int causal,
                      int window, float scale, cudaStream_t stream) {
  using L = Bf16Tiles<NP, BN>;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap qm, km, vm;
  if (!bf16_map(enc, &qm, q, batch, S, H, D, kBm) ||
      !bf16_map(enc, &km, k, batch, S, KH, D, BN) ||
      !bf16_map(enc, &vm, v, batch, S, KH, Dv, BN))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_bf16<NP, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBm - 1) / kBm * H * batch,
                  (Dv + kVPanel - 1) / kVPanel);
  flash_wgmma_bf16<NP, BN><<<grid, kBf16Threads, L::kSmem, stream>>>(
      qm, km, vm, o, S, H, KH, D, Dv, causal, window, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// The tiles D takes: two 64-column panels or three take 128-key tiles,
// four only 64.
int launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                const __nv_bfloat16* v, __nv_bfloat16* o, int batch, int S,
                int H, int KH, int D, int Dv, int causal, int window,
                float scale, int max_dim, cudaStream_t stream) {
  if (!valid_shape(batch, S, H, KH, D, Dv, window, kBm, max_dim))
    return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 128)
    return launch_bf16_tiles<2, 128>(q, k, v, o, batch, S, H, KH, D, Dv,
                                     causal, window, scale, stream);
  if (D <= 192)
    return launch_bf16_tiles<3, 128>(q, k, v, o, batch, S, H, KH, D, Dv,
                                     causal, window, scale, stream);
  return launch_bf16_tiles<4, 64>(q, k, v, o, batch, S, H, KH, D, Dv, causal,
                                  window, scale, stream);
}

int launch_f32(const float* q, const float* k, const float* v, float* o,
               int batch, int S, int H, int KH, int D, int causal, int window,
               float scale, cudaStream_t stream) {
  if (!valid_shape(batch, S, H, KH, D, D, window, kF32Bm, kFaMaxDim))
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

template <int NP, int BN>
int launch_wide_f32_tiles(const float* q, const float* k, const float* v,
                          float* o, int batch, int S, int H, int KH, int D,
                          int Dv, int causal, int window, float scale,
                          cudaStream_t stream) {
  using L = WideF32<NP, BN>;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_wide_tf32<NP, BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kF32Bm - 1) / kF32Bm * H * batch,
                  (Dv + kVPanel - 1) / kVPanel);
  flash_wgmma_wide_tf32<NP, BN><<<grid, kF32Threads, L::kSmem, stream>>>(
      q, k, v, o, S, H, KH, D, Dv, causal, window, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// Six 32-column panels leave room for 32-key tiles; eight only for 16.
int launch_wide_f32(const float* q, const float* k, const float* v, float* o,
                    int batch, int S, int H, int KH, int D, int Dv,
                    int causal, int window, float scale,
                    cudaStream_t stream) {
  if (!valid_shape(batch, S, H, KH, D, Dv, window, kF32Bm, kWideMaxDim))
    return static_cast<int>(cudaErrorInvalidValue);
  return D <= 192 ? launch_wide_f32_tiles<6, 32>(q, k, v, o, batch, S, H, KH,
                                                 D, Dv, causal, window, scale,
                                                 stream)
                  : launch_wide_f32_tiles<8, 16>(q, k, v, o, batch, S, H, KH,
                                                 D, Dv, causal, window, scale,
                                                 stream);
}

}  // namespace
}  // namespace repro_torch

// o (B, S, H, D) = attention(q, k, v).  q, k, v and o (B, S, H or KH, D)
// in the entry's type, contiguous, 16-byte aligned, on the stream's
// device; H % KH == 0, D a multiple of 8 up to 128.  causal != 0 masks
// keys after the query; window > 0 masks keys `window` or more positions
// before it.  Returns cudaGetLastError() after the launch (0 on success),
// or the error that kept it from launching.
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
                                  headdim, headdim, causal, window, scale,
                                  repro_torch::kFaMaxDim, stream);
}

// The same function for D a multiple of 8 up to 256 and V of its own
// width: v (B, S, KH, vdim) and o (B, S, H, vdim), vdim a multiple of 8 up
// to D; the wrapper sends it D above 128 only.
extern "C" int flash_attention_wide_f32(const float* q, const float* k,
                                        const float* v, float* o, int batch,
                                        int seqlen, int heads, int kv_heads,
                                        int headdim, int vdim, int causal,
                                        int window, float scale,
                                        cudaStream_t stream) {
  return repro_torch::launch_wide_f32(q, k, v, o, batch, seqlen, heads,
                                      kv_heads, headdim, vdim, causal, window,
                                      scale, stream);
}

extern "C" int flash_attention_wide_bf16(const __nv_bfloat16* q,
                                         const __nv_bfloat16* k,
                                         const __nv_bfloat16* v,
                                         __nv_bfloat16* o, int batch,
                                         int seqlen, int heads, int kv_heads,
                                         int headdim, int vdim, int causal,
                                         int window, float scale,
                                         cudaStream_t stream) {
  return repro_torch::launch_bf16(q, k, v, o, batch, seqlen, heads, kv_heads,
                                  headdim, vdim, causal, window, scale,
                                  repro_torch::kWideMaxDim, stream);
}
