// Mamba2 SSD chunked scan (state-space duality) on Hopper's tensor cores
// (sm_90a).
//
// Replaces: src/repro/kernels/ssd/kernel.py::ssd_scan (the Pallas body
// _kernel), whose grid (B, H, chunks) runs the chunk axis in sequence and
// carries the (P, N) state in VMEM scratch.
//
// The function.  Per batch b, head h and chunk of C steps, with
// seg = cumsum(dt a) over the chunk, last = seg[C - 1] and G = C_c B_c^T
// (C x C, shared by every head of h's group of B and C: B and C are
// (B, T, ngroups, N) and head h reads group h / (H / ngroups)):
//   y   = (G o exp(seg_i - seg_j) o dt_j) X + exp(seg_i) (C h^T) + d X,
//   h  <- h exp(last) + (X o w)^T B,  w_j = exp(last - seg_j) dt_j,
// the exponent masked to -inf above the diagonal (exp gives 0, never
// inf * 0); y in the input type, all recurrence math in f32.  On request
// the scan also writes h at the last chunk's end (B, H, P, N, f32), the
// state a prefill hands to decode.
//
// What bounds it on an H100: operations.  Per (batch, head, chunk) the scan
// does three products (scores X, C h^T and the state update) and G once per
// (batch, chunk): 1.85 GFLOP at the serve shape of mamba2-130m (B = 4,
// T = 512, H = 24, P = 64, N = 128, C = 64) against 27.5 MB of inputs and
// output, some 67 operations per byte.  On the tensor cores at f32
// accuracy (three TF32 products each) that is 0.0112 ms (3 x 1.85 GFLOP at
// 495 TFLOP/s), above the 0.0082 ms the bytes take.
//
// Design: two launches on the caller's stream, the first a prologue.
//   * The prologue (ssd_gram_kernel, kGramSplit blocks a (chunk, batch,
//     group)) forms what every head and state slice of a chunk shares:
//     G = C B^T once per (batch, chunk, group), a warp a 16 x 8 tile, and
//     seg of every head of the group,
//     a warp a head, added in sequence in f32 as the plain version's cumsum
//     adds on the card (a shuffle chain; seg reaches hundreds at the serve
//     shape and exp(seg_i - seg_j) passes its rounding on to y, so a
//     tree-ordered scan lands ~1x the f32 tolerance away, the serial one
//     does not).  Both go to a workspace ((B, chunks, groups, cp, cp) and
//     (B, chunks, H, cp) f32, 0.7 MB at the serve shape, read back from L2)
//     that the entry points take from a stream-ordered pool of their own,
//     since their signatures carry none.  The scan is launched as the
//     prologue's programmatic dependent: its blocks start, zero their state
//     and stage their first piece while the prologue runs, and wait for it
//     (griddepcontrol.wait) before they read seg or G.
//   * The state splits along P: row p of h reads only column p of x and
//     writes only column p of y.  A scan block (ssd_mma_kernel) owns one
//     head and kSsdWidth = 32 of its P columns (two 16-row slices), so the
//     grid is H ceil(P / 32) x B blocks (192 at the serve shape, two an SM),
//     and walks the chunks in order; its f32 state (32 x N) stays in shared
//     memory for the whole walk and is updated in the reference's order,
//     h = h exp(last) + S, in IEEE f32; after the walk it is copied out
//     when the caller asks for the final state.
//   * Products on the tensor cores with mma.sync m16n8k8 in TF32, carried at
//     f32 accuracy as three products (3xTF32): each f32 operand x splits
//     into big = tf32_rna(x) and small = tf32_rna(x - big), and
//     small.big + big.small + big.big goes into the f32 accumulator.  x, B
//     and C in bf16 are exact in TF32 (small = 0), so the bf16 entry takes
//     one product for G and two for the others.  The products are
//     transposed so that the state is the A operand in place:
//       G      = C B^T               (prologue; chunk x chunk, over N);
//       y^T   += h C^T               (32 x chunk, over N);
//       S      = (X o w)^T B         (32 x N, over the chunk);
//       y^T    = exp(seg_i) y^T + X^T scores^T   (at the chunk's end),
//     with scores = G o exp(seg_i - seg_j) o dt_j formed where they are
//     loaded, the exponent masked above the diagonal (0 there).  Every
//     product is summed over its depth in pieces of kSsdPiece steps, each
//     from zero, and the pieces are added in IEEE f32: the tensor cores'
//     accumulation is not IEEE, and one chain over a wide state drifts past
//     the f32 tolerance (the pieces are also independent chains).
//   * Warps by product: four Y warps own two 8-column steps of y^T each
//     (h C^T over the pieces, and at the chunk's end the first half of the
//     chunk's steps of X^T scores^T and the store); four S warps own 8
//     columns of each piece of S and of the state, and at the chunk's end
//     the second half of the steps for their Y warp's columns, handed over
//     in shared memory.  Named barriers order the state's reads before its
//     update, w before S and the handover before the store.  Each product
//     site runs one TF32 pass over all its tiles before the next, so
//     consecutive mma are independent.
//   * Overlap: B and C arrive in pieces of kSsdPiece state columns through a
//     two-stage cp.async ring that runs across chunk boundaries, so the next
//     piece (and, with a chunk's first piece, the x slice, dt and seg)
//     lands while this piece's products run, and two blocks an SM hide
//     each other's waits.
//   * Shapes: the chunk pads to a multiple of 16, N to a multiple of
//     kSsdPiece, P to the block's 32 columns; the padding is zero-filled by
//     cp.async (dt = 0 there, so padded steps add nothing) and never
//     stored.  The state holds min(32, P) rows, so shared memory
//     (ssd_smem: 86.25 KiB at the serve shape in f32) grows with N by
//     128 bytes a column: N up to 1,248 at P >= 32, chunk 64, f32.
#include <cuda_bf16.h>

#include <climits>
#include <cstdint>
#include <mutex>

#include "common.cuh"

namespace repro_torch {
namespace {

// kSsdUnits, kSsdPiece and kSsdPad are copied in ssd/ops.py (smem_bytes);
// a test evaluates these constexpr lines and ssd_smem's regions and holds
// the copy to them, and ssd_scan_smem_bytes exports ssd_smem.
constexpr int kSsdUnits = 2;                 // 16-row state slices a block
constexpr int kSsdWarps = 8;                 // four Y and four S warps
constexpr int kSsdThreads = 32 * kSsdWarps;
constexpr int kSsdWidth = 16 * kSsdUnits;    // state rows a block
constexpr int kSsdBlocksPerSm = 2;           // at the serve shape
constexpr int kSsdPiece = 32;  // columns a staged piece, steps a product's
constexpr int kSsdPad = 8;                   // row padding of tiles (elements)
constexpr int kSsdMaxChunk = 64;
constexpr size_t kSsdMaxSmem = 232448;       // dynamic shared memory a block
constexpr int kGramWarps = 8;
constexpr int kGramThreads = 32 * kGramWarps;
constexpr int kGramSplit = 3;                // prologue blocks a chunk
constexpr int kBarState = 1;  // the Y warps have read a piece of the state
constexpr int kBarW = 2;      // w of a chunk is ready (S warps)
constexpr int kBarEnd = 3;    // the S warps' half of the chunk's end is ready

template <typename T>
struct ExactTf32 {
  static constexpr bool value = false;
};
template <>
struct ExactTf32<__nv_bfloat16> {  // 8-bit mantissa: exact in TF32
  static constexpr bool value = true;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// Two neighbouring elements (an even offset) as f32.
__device__ __forceinline__ float2 pair_f32(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair_f32(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Copies kBytes from global to shared memory asynchronously, or writes
// zeros when !valid (src is then not read).
template <int kBytes>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
               "l"(src), "n"(kBytes), "r"(valid ? kBytes : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Named barrier `id` (1-15) over `count` threads: unit_sync waits for
// them all, unit_arrive signals without waiting (a producer's side).
__device__ __forceinline__ void unit_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void unit_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// d (16 x 8, f32) += a (16 x 8, TF32) b (8 x 8, TF32).  Lane (g, t) =
// (lane / 4, lane % 4) holds a at (g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4); b at (t, g), (t + 4, g); d at (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};
// big and small TF32 parts of v; a value exact in TF32 is its own big part.
template <bool kExact>
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  if (kExact) {
    hi = __float_as_uint(v);
    lo = 0u;
  } else {
    split_tf32(v, hi, lo);
  }
}
template <bool kExact>
__device__ __forceinline__ FragA frag_a(float a0, float a1, float a2,
                                        float a3) {
  FragA f;
  split<kExact>(a0, f.hi[0], f.lo[0]);
  split<kExact>(a1, f.hi[1], f.lo[1]);
  split<kExact>(a2, f.hi[2], f.lo[2]);
  split<kExact>(a3, f.hi[3], f.lo[3]);
  return f;
}
template <bool kExact>
__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  split<kExact>(b0, f.hi[0], f.lo[0]);
  split<kExact>(b1, f.hi[1], f.lo[1]);
  return f;
}
// d += a b at f32 accuracy is three products, in this order: pass 0
// small.big, pass 1 big.small, pass 2 big.big; a pass whose small operand
// is exact in TF32 (0) is skipped.  The call sites run a pass over all
// their tiles before the next, so consecutive mma are independent and the
// tensor pipe overlaps them (a pass chained on the one before waits the
// whole mma latency).
__device__ __forceinline__ void mma_pass(int pass, float (&d)[4],
                                         const FragA& a, const FragB& b) {
  if (pass == 0)
    mma_tf32(d, a.lo, b.hi[0], b.hi[1]);
  else if (pass == 1)
    mma_tf32(d, a.hi, b.lo[0], b.lo[1]);
  else
    mma_tf32(d, a.hi, b.hi[0], b.hi[1]);
}
template <bool kAExact, bool kBExact>
__device__ __forceinline__ constexpr bool takes(int pass) {
  return pass == 2 || (pass == 0 && !kAExact) || (pass == 1 && !kBExact);
}

// Byte offsets of the main kernel's shared-memory regions (each 16-byte
// aligned) for a chunk padded to cp, a state of `rows` rows padded to npad
// columns and inputs of esize bytes.
struct SsdSmem {
  size_t c, b, x, dt, h, w, yx, total;
};
__host__ __device__ __forceinline__ size_t align16(size_t v) {
  return (v + 15) & ~static_cast<size_t>(15);
}
__host__ __device__ __forceinline__ SsdSmem ssd_smem(int cp, int npad,
                                                     int rows, int esize) {
  const size_t tile = static_cast<size_t>(cp) * (kSsdPiece + kSsdPad);
  SsdSmem s;
  size_t off = 0;
  s.c = off;  // C pieces [2][cp][kSsdPiece + kSsdPad], input type
  off += align16(2 * tile * esize);
  s.b = off;  // B pieces, the same
  off += align16(2 * tile * esize);
  s.x = off;  // x slices [2][cp][kSsdWidth + kSsdPad], input type
  off += align16(2 * static_cast<size_t>(cp) * (kSsdWidth + kSsdPad) * esize);
  s.dt = off;  // dt [2][cp], then seg [2][cp]
  off += align16(4 * static_cast<size_t>(cp) * 4);
  s.h = off;  // state [rows][npad + kSsdPad]
  off += align16(static_cast<size_t>(rows) * (npad + kSsdPad) * 4);
  s.w = off;  // w [cp]
  off += align16(static_cast<size_t>(cp) * 4);
  s.yx = off;  // the S warps' half of X^T scores^T [4][kSsdUnits][2][4][32]
  off += align16(static_cast<size_t>(4) * kSsdUnits * 8 * 32 * 4);
  s.total = off;
  return s;
}

// ---------------------------------------------------------------- prologue
// Block (chunk, batch, z), z < kGramSplit ngroups, so kGramSplit kGramWarps
// warps a (batch, chunk, group): seg of the group's heads (a warp a head)
// and G = C B^T in the lower triangle's 16 x 8 tiles (a warp a tile), each
// summed over N in k-steps of 8 as three TF32 products, from zero a piece
// of kSsdPiece columns, the pieces added in IEEE f32.
template <typename T>
__global__ void __launch_bounds__(kGramThreads)
ssd_gram_kernel(const float* __restrict__ dt, const float* __restrict__ a_neg,
                const T* __restrict__ bm, const T* __restrict__ cm,
                float* __restrict__ gram, float* __restrict__ segs,
                int seqlen, int nheads, int N, int ngroups, int C) {
  constexpr bool kX = ExactTf32<T>::value;  // B and C exact in TF32
  constexpr int kAll = kGramSplit * kGramWarps;  // warps a (batch, chunk,
                                                 // group)
  // the scan's blocks may start (and stage their first piece) meanwhile
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int cp = (C + 15) & ~15;
  const int nch = seqlen / C;
  const int lane = threadIdx.x & 31;
  const int grp = blockIdx.z / kGramSplit;
  const int gw =
      (blockIdx.z - grp * kGramSplit) * kGramWarps + (threadIdx.x >> 5);
  const int g = lane >> 2, t = lane & 3;
  const size_t cell = static_cast<size_t>(blockIdx.y) * nch + blockIdx.x;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * seqlen +
                      static_cast<size_t>(blockIdx.x) * C;
  const size_t gn = static_cast<size_t>(ngroups) * N;  // a step's B (or C)
  bm += static_cast<size_t>(grp) * N;
  cm += static_cast<size_t>(grp) * N;
  const int hpg = nheads / ngroups;

  // seg_i = ((dt_0 a + dt_1 a) + ...) + dt_i a in f32, in sequence: every
  // lane carries the sum and keeps its own two steps (dt is 0 past C, so
  // seg stays at last there)
  for (int hh = grp * hpg + gw; hh < (grp + 1) * hpg; hh += kAll) {
    const float a = a_neg[hh];
    const float d0 =
        lane < C ? rn_mul(dt[(row0 + lane) * nheads + hh], a) : 0.0f;
    const float d1 =
        lane + 32 < C ? rn_mul(dt[(row0 + lane + 32) * nheads + hh], a) : 0.0f;
    float sum = 0.0f, s0 = 0.0f, s1 = 0.0f;
#pragma unroll
    for (int i = 0; i < kSsdMaxChunk; ++i) {
      sum = rn_add(sum, __shfl_sync(kFullMask, i < 32 ? d0 : d1, i & 31));
      if (lane == (i & 31)) {
        if (i < 32)
          s0 = sum;
        else
          s1 = sum;
      }
    }
    float* out = segs + (cell * nheads + hh) * cp;
    if (lane < cp) out[lane] = s0;
    if (lane + 32 < cp) out[lane + 32] = s1;
  }

  // G: band r of 16 rows holds 2 (r + 1) tiles of 8 columns
  float* gout = gram + (cell * ngroups + grp) * cp * cp;
  const int bands = cp / 16, tiles = bands * (bands + 1);
  for (int tau = gw; tau < tiles; tau += kAll) {
    int r = 0;
    while ((r + 1) * (r + 2) <= tau) ++r;
    const int i0 = r * 16 + g, j0 = (tau - r * (r + 1)) * 8 + g;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int n0 = 0; n0 < N; n0 += kSsdPiece) {
      float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      FragA fa[kSsdPiece / 8];
      FragB fb[kSsdPiece / 8];
#pragma unroll
      for (int kk = 0; kk < kSsdPiece / 8; ++kk) {
        // k order within the step: column 2t as k = t, 2t + 1 as t + 4
        const int n = n0 + kk * 8 + 2 * t;
        const float2 z = make_float2(0.0f, 0.0f);
        const float2 c0 =
            n < N && i0 < C ? pair_f32(cm + (row0 + i0) * gn + n) : z;
        const float2 c1 =
            n < N && i0 + 8 < C ? pair_f32(cm + (row0 + i0 + 8) * gn + n) : z;
        const float2 bv =
            n < N && j0 < C ? pair_f32(bm + (row0 + j0) * gn + n) : z;
        fa[kk] = frag_a<kX>(c0.x, c1.x, c0.y, c1.y);
        fb[kk] = frag_b<kX>(bv.x, bv.y);
      }
#pragma unroll
      for (int kk = 0; kk < kSsdPiece / 8; ++kk)
#pragma unroll
        for (int pass = 0; pass < 3; ++pass)
          if (takes<kX, kX>(pass)) mma_pass(pass, part, fa[kk], fb[kk]);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[e] = rn_add(acc[e], part[e]);
    }
    float* g0 = gout + i0 * cp + j0 - g + 2 * t;
    *reinterpret_cast<float2*>(g0) = make_float2(acc[0], acc[1]);
    *reinterpret_cast<float2*>(g0 + 8 * cp) = make_float2(acc[2], acc[3]);
  }
}

// ------------------------------------------------------------- main kernel
template <typename T>
__global__ void __launch_bounds__(kSsdThreads, kSsdBlocksPerSm)
ssd_mma_kernel(const T* __restrict__ x, const float* __restrict__ dt,
               const T* __restrict__ bm, const T* __restrict__ cm,
               const float* __restrict__ dskip,
               const float* __restrict__ gram, const float* __restrict__ segs,
               T* __restrict__ y, float* __restrict__ state_out, int seqlen,
               int nheads, int P, int N, int ngroups, int C) {
  constexpr bool kX = ExactTf32<T>::value;  // x, B and C exact in TF32
  constexpr int kGran = 4 * sizeof(T);      // one cp.async: 4 elements
  constexpr int kPieceGran = kSsdPiece / 4;
  constexpr int kNt = kSsdPiece / 8;  // 8-column tiles a piece
  const int cp = (C + 15) & ~15;
  const int npad = (N + kSsdPiece - 1) / kSsdPiece * kSsdPiece;
  const int rows = min(kSsdWidth, P);  // state rows held
  const int pieces = npad / kSsdPiece;
  const int nch = seqlen / C;
  const int total = nch * pieces;
  const int qs = kSsdPiece + kSsdPad;   // row stride of a B / C piece
  const int xsd = kSsdWidth + kSsdPad;  // row stride of an x slice
  const int hsd = npad + kSsdPad;       // row stride of the state
  const SsdSmem lay = ssd_smem(cp, npad, rows, sizeof(T));
  extern __shared__ __align__(16) unsigned char smem[];
  T* cs = reinterpret_cast<T*>(smem + lay.c);
  T* bs = reinterpret_cast<T*>(smem + lay.b);
  T* xs = reinterpret_cast<T*>(smem + lay.x);
  float* ds = reinterpret_cast<float*>(smem + lay.dt);
  float* ss = ds + 2 * cp;  // seg [2][cp]
  float* hs = reinterpret_cast<float*>(smem + lay.h);
  float* wv = reinterpret_cast<float*>(smem + lay.w);  // exp(last - seg_j) dt_j
  float* yx = reinterpret_cast<float*>(smem + lay.yx);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int pchunks = (P + kSsdWidth - 1) / kSsdWidth;
  const int h = blockIdx.x / pchunks;
  const int pb = (blockIdx.x - h * pchunks) * kSsdWidth;  // block's first p
  const int grp = h / (nheads / ngroups);  // h's group of B and C
  const float dd = dskip[h];
  const size_t row0 = static_cast<size_t>(blockIdx.y) * seqlen;
  const size_t gn = static_cast<size_t>(ngroups) * N;  // a step's B (or C)
  const size_t gram_cell = static_cast<size_t>(ngroups) * cp * cp;
  const float* gram_b = gram +
                        static_cast<size_t>(blockIdx.y) * nch * gram_cell +
                        static_cast<size_t>(grp) * cp * cp;
  const float* seg_bh =
      segs + (static_cast<size_t>(blockIdx.y) * nch * nheads + h) * cp;
  const bool ywarp = warp < 4;  // else an S warp
  const int q = warp & 3;

  auto stage_seg = [&](int ck) {
    const uint32_t sdst = smem_u32(ss + (ck & 1) * cp);
    const float* sg = seg_bh + static_cast<size_t>(ck) * nheads * cp;
    for (int i = tid; i < cp / 4; i += kSsdThreads)
      cp_async<16>(sdst + i * 16, sg + i * 4, true);
  };
  // Stage piece k (global over chunks): columns of B and C, and with a
  // chunk's first piece its x slice, dt and seg.  One commit group a piece.
  auto stage_piece = [&](int k, bool with_seg) {
    const int ck = k / pieces, qk = k - ck * pieces;
    const int t0 = ck * C, n0 = qk * kSsdPiece;
    const uint32_t cdst = smem_u32(cs + (k & 1) * cp * qs);
    const uint32_t bdst = smem_u32(bs + (k & 1) * cp * qs);
    for (int i = tid; i < cp * kPieceGran; i += kSsdThreads) {
      const int j = i / kPieceGran, c4 = (i - j * kPieceGran) * 4;
      const bool ok = j < C && n0 + c4 < N;
      const size_t off =
          ok ? (row0 + t0 + j) * gn + static_cast<size_t>(grp) * N + n0 + c4
             : 0;
      const uint32_t o = (j * qs + c4) * sizeof(T);
      cp_async<kGran>(cdst + o, cm + off, ok);
      cp_async<kGran>(bdst + o, bm + off, ok);
    }
    if (qk == 0) {
      const int slot = ck & 1;
      const uint32_t xdst = smem_u32(xs + slot * cp * xsd);
      for (int i = tid; i < cp * (kSsdWidth / 4); i += kSsdThreads) {
        const int j = i / (kSsdWidth / 4), c4 = (i - j * (kSsdWidth / 4)) * 4;
        const bool ok = j < C && pb + c4 < P;
        const size_t off =
            ok ? ((row0 + t0 + j) * nheads + h) * P + pb + c4 : 0;
        cp_async<kGran>(xdst + (j * xsd + c4) * sizeof(T), x + off, ok);
      }
      const uint32_t ddst = smem_u32(ds + slot * cp);
      for (int j = tid; j < cp; j += kSsdThreads) {
        const bool ok = j < C;
        cp_async<4>(ddst + j * 4, dt + (ok ? (row0 + t0 + j) * nheads + h : 0),
                    ok);
      }
      if (with_seg) stage_seg(ck);
    }
    cp_async_commit();
  };

  // Y warps: output columns (8 steps each) of y^T; column steps r and
  // isteps - 1 - r share a warp, so the four get equal triangle work at
  // chunk 64.  A warp with fewer than two (a chunk below 64) repeats
  // column 0 and stores nothing of it: the products run without branches,
  // so the compiler interleaves their chains.
  const int isteps = cp / 8;
  int my_i[2] = {0, 0};
  int n_i = 0;  // at most 2; constant indices keep my_i in registers
#pragma unroll
  for (int r = 0; r < kSsdMaxChunk / 8; ++r) {
    const int owner = (r < isteps / 2 ? r : isteps - 1 - r) & 3;
    if (r < isteps && owner == q) {
#pragma unroll
      for (int s = 0; s < 2; ++s)
        if (s == n_i) my_i[s] = r * 8;
      ++n_i;
    }
  }

  for (int i = tid; i < rows * hsd; i += kSsdThreads) hs[i] = 0.0f;
  stage_piece(0, false);
  // the prologue's seg and G are complete and visible past this point (the
  // scan is launched as its programmatic dependent)
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  stage_seg(0);
  cp_async_commit();

  float acc[kSsdUnits][2][4];  // Y warps: y^T of the chunk
  float dec = 1.0f;            // S warps: exp(last)
  for (int k = 0; k < total; ++k) {
    const int ck = k / pieces, qk = k - ck * pieces, slot = ck & 1;
    cp_async_wait_all();
    __syncthreads();  // piece k landed; every warp is done with piece k - 1
    if (k + 1 < total) stage_piece(k + 1, true);
    const T* cq = cs + (k & 1) * cp * qs;
    const T* bq = bs + (k & 1) * cp * qs;
    const T* xq = xs + slot * cp * xsd;
    const float* dq = ds + slot * cp;
    const float* sq = ss + slot * cp;

    if (ywarp) {
      // ---- Y warps: y^T += h_q C_q^T, this warp's columns ----------------
      if (qk == 0) {
#pragma unroll
        for (int u = 0; u < kSsdUnits; ++u)
#pragma unroll
          for (int s = 0; s < 2; ++s)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[u][s][e] = 0.0f;
      }
      float part[kSsdUnits][2][4];
#pragma unroll
      for (int u = 0; u < kSsdUnits; ++u)
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[u][s][e] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kNt; ++kk) {
        // k order within the step: column 2t as k = t, 2t + 1 as t + 4
        const int n = kk * 8 + 2 * t;
        FragB fb[2];
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const float2 cv = pair_f32(cq + (my_i[s] + g) * qs + n);
          fb[s] = frag_b<kX>(cv.x, cv.y);
        }
        FragA fa[kSsdUnits];
#pragma unroll
        for (int u = 0; u < kSsdUnits; ++u) {
          const int r0 = u * 16 + g;
          const float* hq = hs + qk * kSsdPiece + n;
          const float2 h0 = r0 < rows ? pair_f32(hq + r0 * hsd)
                                      : make_float2(0.0f, 0.0f);
          const float2 h1 = r0 + 8 < rows ? pair_f32(hq + (r0 + 8) * hsd)
                                          : make_float2(0.0f, 0.0f);
          fa[u] = frag_a<false>(h0.x, h1.x, h0.y, h1.y);
        }
#pragma unroll
        for (int pass = 0; pass < 3; ++pass)
          if (takes<false, kX>(pass))
#pragma unroll
            for (int u = 0; u < kSsdUnits; ++u)
#pragma unroll
              for (int s = 0; s < 2; ++s)
                mma_pass(pass, part[u][s], fa[u], fb[s]);
      }
      unit_arrive(kBarState, kSsdThreads);  // the state of piece k is read
#pragma unroll
      for (int u = 0; u < kSsdUnits; ++u)
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[u][s][e] = rn_add(acc[u][s][e], part[u][s][e]);
    } else {
      // ---- S warps: S = (X o w)^T B_q on 8 columns, then their state -----
      if (qk == 0) {
        const int j = tid - 4 * 32;
        if (j < cp) wv[j] = rn_mul(expf(rn_sub(sq[cp - 1], sq[j])), dq[j]);
        dec = expf(sq[cp - 1]);
        unit_sync(kBarW, 4 * 32);
      }
      // over the chunk's steps in halves of kSsdPiece, each summed from
      // zero (two independent chains), then added in IEEE f32
      float sacc[2][kSsdUnits][4];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int u = 0; u < kSsdUnits; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) sacc[hf][u][e] = 0.0f;
#pragma unroll
      for (int j0 = 0; j0 < kSsdMaxChunk / 2; j0 += 8) {
        if (j0 < cp) {
          FragA fa[2][kSsdUnits];
          FragB fb[2];
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            // past cp the second half reads the first's rows and adds 0
            const int j =
                (hf * kSsdPiece + j0 < cp ? hf * kSsdPiece : 0) + j0 + t;
            const float w0 = wv[j], w1 = wv[j + 4];
            fb[hf] = frag_b<kX>(to_f32(bq[j * qs + q * 8 + g]),
                                to_f32(bq[(j + 4) * qs + q * 8 + g]));
#pragma unroll
            for (int u = 0; u < kSsdUnits; ++u) {
              const T* x0 = xq + j * xsd + u * 16 + g;
              const T* x1 = xq + (j + 4) * xsd + u * 16 + g;
              fa[hf][u] = frag_a<false>(
                  rn_mul(to_f32(x0[0]), w0), rn_mul(to_f32(x0[8]), w0),
                  rn_mul(to_f32(x1[0]), w1), rn_mul(to_f32(x1[8]), w1));
            }
          }
          const bool second = kSsdPiece + j0 < cp;
#pragma unroll
          for (int pass = 0; pass < 3; ++pass)
            if (takes<false, kX>(pass))
#pragma unroll
              for (int u = 0; u < kSsdUnits; ++u) {
                mma_pass(pass, sacc[0][u], fa[0][u], fb[0]);
                if (second) mma_pass(pass, sacc[1][u], fa[1][u], fb[1]);
              }
        }
      }
      unit_sync(kBarState, kSsdThreads);  // the Y warps have read the state
      const int col = qk * kSsdPiece + q * 8 + 2 * t;
#pragma unroll
      for (int u = 0; u < kSsdUnits; ++u) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = u * 16 + g + 8 * half;
          if (r < rows) {
            float2* hp = reinterpret_cast<float2*>(hs + r * hsd + col);
            const float2 v = *hp;
            const float s0 = rn_add(sacc[0][u][2 * half], sacc[1][u][2 * half]);
            const float s1 =
                rn_add(sacc[0][u][2 * half + 1], sacc[1][u][2 * half + 1]);
            *hp = make_float2(rn_add(rn_mul(v.x, dec), s0),
                              rn_add(rn_mul(v.y, dec), s1));
          }
        }
      }
    }

    if (qk != pieces - 1) continue;
    // ---- the chunk's end: y^T = exp(seg_i) y^T + X^T scores^T, with
    // scores_ij = G_ij exp(seg_i - seg_j) dt_j (0 for j > i), the product
    // over the chunk's steps in halves of kSsdPiece, each summed from zero:
    // Y warp q takes the first half, S warp q the second, of the same
    // columns (my_i), and hands its sum over in shared memory
    const float* gck = gram_b + static_cast<size_t>(ck) * gram_cell;
    const int hf = ywarp ? 0 : 1;
    const bool halves = cp > kSsdPiece;
    float part[kSsdUnits][2][4];
#pragma unroll
    for (int u = 0; u < kSsdUnits; ++u)
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[u][s][e] = 0.0f;
    if (!ywarp && !halves) continue;
#pragma unroll
    for (int jh = 0; jh < kSsdPiece / 8; ++jh) {
      const int js = hf * (kSsdPiece / 8) + jh;
      if (js * 8 < cp) {
        const int j = js * 8 + t;
        FragB fb[2];
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int i = my_i[s] + g;
          const float si = sq[i];
          const float v0 =
              j <= i ? rn_mul(rn_mul(gck[i * cp + j], expf(rn_sub(si, sq[j]))),
                              dq[j])
                     : 0.0f;
          const float v1 =
              j + 4 <= i
                  ? rn_mul(rn_mul(gck[i * cp + j + 4],
                                  expf(rn_sub(si, sq[j + 4]))),
                           dq[j + 4])
                  : 0.0f;
          fb[s] = frag_b<false>(v0, v1);
        }
        FragA fa[kSsdUnits];
#pragma unroll
        for (int u = 0; u < kSsdUnits; ++u) {
          const T* xu = xq + u * 16;
          fa[u] = frag_a<kX>(
              to_f32(xu[j * xsd + g]), to_f32(xu[j * xsd + g + 8]),
              to_f32(xu[(j + 4) * xsd + g]), to_f32(xu[(j + 4) * xsd + g + 8]));
        }
#pragma unroll
        for (int pass = 0; pass < 3; ++pass)
          if (takes<kX, false>(pass))
#pragma unroll
            for (int u = 0; u < kSsdUnits; ++u)
#pragma unroll
              for (int s = 0; s < 2; ++s)
                mma_pass(pass, part[u][s], fa[u], fb[s]);
      }
    }
    float* handed = yx + (q * kSsdUnits * 8) * 32 + lane;
    if (!ywarp) {
#pragma unroll
      for (int u = 0; u < kSsdUnits; ++u)
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            handed[((u * 2 + s) * 4 + e) * 32] = part[u][s][e];
      unit_arrive(kBarEnd, kSsdThreads);
      continue;
    }
    if (halves) unit_sync(kBarEnd, kSsdThreads);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float e0 = expf(sq[my_i[s] + 2 * t]);
      const float e1 = expf(sq[my_i[s] + 2 * t + 1]);
#pragma unroll
      for (int u = 0; u < kSsdUnits; ++u) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[u][s][e] = rn_add(
              rn_mul(e & 1 ? e1 : e0, acc[u][s][e]),
              rn_add(part[u][s][e],
                     halves ? handed[((u * 2 + s) * 4 + e) * 32] : 0.0f));
      }
    }
    // y = y^T + d x, in the input type
    const size_t yrow = row0 + static_cast<size_t>(ck) * C;
#pragma unroll
    for (int u = 0; u < kSsdUnits; ++u) {
      const int p0 = pb + u * 16;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        if (s < n_i) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int p = g + (e >= 2 ? 8 : 0);
            const int i = my_i[s] + 2 * t + (e & 1);
            if (i < C && p0 + p < P) {
              const float xi = to_f32(xq[i * xsd + u * 16 + p]);
              store_as(y + ((yrow + i) * nheads + h) * P + p0 + p,
                       rn_add(acc[u][s][e], rn_mul(dd, xi)));
            }
          }
        }
      }
    }
  }
  if (state_out == nullptr) return;
  // the state at the last chunk's end: this block's rows of h
  __syncthreads();
  float* so =
      state_out + (static_cast<size_t>(blockIdx.y) * nheads + h) * P * N;
  for (int i = tid; i < rows * N; i += kSsdThreads) {
    const int r = i / N, n = i - r * N;
    if (pb + r < P) so[static_cast<size_t>(pb + r) * N + n] = hs[r * hsd + n];
  }
}

size_t ssd_smem_bytes(int P, int N, int C, int esize) {
  return ssd_smem((C + 15) & ~15, (N + kSsdPiece - 1) / kSsdPiece * kSsdPiece,
                  P < kSsdWidth ? P : kSsdWidth, esize)
      .total;
}

// `bytes` from a stream-ordered pool of the current device that keeps its
// memory between calls (a pool of this library's own, so the setting
// touches no other user of the device's default pool).
cudaError_t ssd_workspace(size_t bytes, cudaStream_t stream, void** out) {
  constexpr int kMaxDevices = 64;
  static std::mutex mu;
  static cudaMemPool_t pools[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  {
    std::lock_guard<std::mutex> lock(mu);
    if (!pools[dev]) {
      cudaMemPoolProps props = {};
      props.allocType = cudaMemAllocationTypePinned;
      props.location.type = cudaMemLocationTypeDevice;
      props.location.id = dev;
      cudaMemPool_t pool;
      err = cudaMemPoolCreate(&pool, &props);
      if (err != cudaSuccess) return err;
      uint64_t keep = UINT64_MAX;
      err = cudaMemPoolSetAttribute(pool, cudaMemPoolAttrReleaseThreshold,
                                    &keep);
      if (err != cudaSuccess) return err;
      pools[dev] = pool;
    }
  }
  return cudaMallocFromPoolAsync(out, bytes, pools[dev], stream);
}

template <typename T>
int launch_ssd(const T* x, const float* dt, const float* a_neg, const T* b,
               const T* c, const float* d, T* y, float* state, int batch,
               int seqlen, int nheads, int P, int N, int ngroups, int C,
               cudaStream_t stream) {
  if (batch <= 0 || nheads <= 0 || C < 4 || C > kSsdMaxChunk || C % 4 ||
      P % 4 || N % 4 || P <= 0 || N <= 0 || seqlen <= 0 || seqlen % C ||
      ngroups <= 0 || nheads % ngroups || ngroups * kGramSplit > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = ssd_smem_bytes(P, N, C, sizeof(T));
  if (smem > kSsdMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_mma_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  {  // all of L1 as shared memory, so kSsdBlocksPerSm blocks fit
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_mma_kernel<T>, cudaFuncAttributePreferredSharedMemoryCarveout,
        100);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int cp = (C + 15) & ~15, nch = seqlen / C;
  const size_t gram_n = static_cast<size_t>(batch) * nch * ngroups * cp * cp;
  const size_t seg_n = static_cast<size_t>(batch) * nch * nheads * cp;
  void* ws = nullptr;
  cudaError_t err =
      ssd_workspace((gram_n + seg_n) * sizeof(float), stream, &ws);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* gram = static_cast<float*>(ws);
  float* segs = gram + gram_n;
  ssd_gram_kernel<T><<<dim3(nch, batch, kGramSplit * ngroups), kGramThreads,
                       0, stream>>>(
      dt, a_neg, b, c, gram, segs, seqlen, nheads, N, ngroups, C);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(nheads * ((P + kSsdWidth - 1) / kSsdWidth), batch);
    cfg.blockDim = dim3(kSsdThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, ssd_mma_kernel<T>, x, dt, b, c, d,
                             static_cast<const float*>(gram),
                             static_cast<const float*>(segs), y, state,
                             seqlen, nheads, P, N, ngroups, C);
  }
  const cudaError_t freed = cudaFreeAsync(ws, stream);
  return static_cast<int>(err != cudaSuccess ? err : freed);
}

}  // namespace
}  // namespace repro_torch

// y (B, T, H, P) = SSD(x, dt, a_neg, b, c, d).  x (B, T, H, P), b and c
// (B, T, ngroups, N) in the entry's type; dt (B, T, H), a_neg =
// -exp(A_log) (H,) and d (H,) f32; all contiguous on the stream's device.
// state, unless null, receives h at the last chunk's end (B, H, P, N, f32).
// T % chunk == 0, chunk a multiple of 4 up to 64, P and N multiples of 4,
// H a multiple of ngroups, and the shared memory of ssd_smem within a
// block's 227 KiB.  Two launches (the prologue, then the scan) and a
// workspace from the library's pool, returned to it on the stream.
// Returns the first CUDA error (0 on success).
extern "C" int ssd_scan_f32(const float* x, const float* dt,
                            const float* a_neg, const float* b,
                            const float* c, const float* d, float* y,
                            float* state, int batch, int seqlen, int nheads,
                            int headdim, int nstate, int ngroups, int chunk,
                            cudaStream_t stream) {
  return repro_torch::launch_ssd<float>(x, dt, a_neg, b, c, d, y, state,
                                        batch, seqlen, nheads, headdim,
                                        nstate, ngroups, chunk, stream);
}

extern "C" int ssd_scan_bf16(const __nv_bfloat16* x, const float* dt,
                             const float* a_neg, const __nv_bfloat16* b,
                             const __nv_bfloat16* c, const float* d,
                             __nv_bfloat16* y, float* state, int batch,
                             int seqlen, int nheads, int headdim, int nstate,
                             int ngroups, int chunk, cudaStream_t stream) {
  return repro_torch::launch_ssd<__nv_bfloat16>(x, dt, a_neg, b, c, d, y,
                                                state, batch, seqlen, nheads,
                                                headdim, nstate, ngroups,
                                                chunk, stream);
}

// Dynamic shared memory of one scan block (ssd_smem) for x, B and C of
// esize bytes, capped at INT_MAX: what ssd/ops.py's smem_bytes copies.
extern "C" int ssd_scan_smem_bytes(int headdim, int nstate, int chunk,
                                   int esize) {
  const size_t s = repro_torch::ssd_smem_bytes(headdim, nstate, chunk, esize);
  return s > static_cast<size_t>(INT_MAX) ? INT_MAX : static_cast<int>(s);
}
