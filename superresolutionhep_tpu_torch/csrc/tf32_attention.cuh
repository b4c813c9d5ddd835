// What the fp32 attention kernels built on Hopper's tensor cores share
// (flash_attention.cu::flash_fwd_f32_kernel, K1/K2/K7 in fp32, and
// flash_attention_bwd.cu::flash_bwd_dq_f32_kernel and ::flash_bwd_dkv_f32_kernel,
// K5/K8 and K6/K9 in fp32):
//
//   * fp32-accurate products from TF32 ones: mma.sync m16n8k8 with each fp32
//     operand x split into hi = rna(x) and lo = rna(x - hi) (x - hi is exact
//     in fp32), each product taken as lo*hi + hi*lo + hi*hi, accumulated in
//     fp32, smallest terms first.  That leaves about 2^-21 of relative error
//     a product (the dropped lo*lo term and lo's rounding), where one TF32
//     product keeps ~2^-11 and would move a base-2 logit of 8 by ~4e-3.
//     ops/tf32_split.py states the same arithmetic in PyTorch for the tests;
//   * the tile geometry: a block of 4 warps owns 64 rows (16 a warp: the M
//     of one m16n8k8), the other axis streams through a cp.async ring of
//     64-row tiles, and only the tiles that hold a cell of the block's ids
//     are visited (a flag per tile, a warp's ballot over the tile's ids).
//
// Fragment layouts of m16n8k8 (g = lane / 4, t = lane % 4):
//   A (16 x 8, row major)  a0 (g, t)   a1 (g + 8, t)   a2 (g, t + 4)     a3 (g + 8, t + 4)
//   B (8 x 8, column)      b0 (t, g)   b1 (t + 4, g)
//   C (16 x 8)             c0 (g, 2t)  c1 (g, 2t + 1)  c2 (g + 8, 2t)    c3 (g + 8, 2t + 1)
// A C fragment (columns 2t, 2t + 1) is no A fragment of the next product
// (columns t, t + 4), but it is one if that product's summed axis is read in
// the order t -> 2t, t + 4 -> 2t + 1 within each 8-wide step: the A operand
// is (c0, c2, c1, c3) and the B operand's rows are read at 2t and 2t + 1.
// A sum does not depend on the order of its terms, so no shuffle is needed.
#pragma once

#include "common.cuh"

namespace srhep {

// TF32 rounding of an fp32 value: round to nearest, ties away from zero, to
// 10 mantissa bits (the low 13 bits of the result are zero).  On the bits:
// two integer instructions, where cvt.rna.tf32.f32 compiles to about five
// (it also sorts out NaN and inf).  For every finite x the two agree; a
// non-finite x makes x - hi, and so lo and the product, NaN either way.
__device__ __forceinline__ uint32_t tf32_rna(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d(16 x 8) += a(16 x 8) * b(8 x 8), TF32 operands, fp32 accumulation
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b from split operands: TERMS = 3 is lo*hi + hi*lo + hi*hi (the
// kernels' setting), TERMS = 1 the single TF32 product hi*hi
template <int TERMS>
__device__ __forceinline__ void mma_split(float (&d)[4], const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                          uint32_t bh0, uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  static_assert(TERMS == 1 || TERMS == 3, "a split product has one term or three");
  if (TERMS == 3) {
    mma_tf32(d, al, bh0, bh1);
    mma_tf32(d, ah, bl0, bl1);
  }
  mma_tf32(d, ah, bh0, bh1);
}

// d += t: a partial sum, summed apart, added with fp32 adds (round to
// nearest).  The tensor cores add an mma's products to its accumulator
// rounding toward zero, relative to the largest term; over a long chain into
// one accumulator that bias adds up coherently, and where the result is small
// against its running sum (an attention output that averages many values, a
// gradient summed over many rows) it moved O by ~2e-5 of its size and failed
// a train step's gradient check at 1e-3.  So the long sums (O, dQ, dK, dV:
// every key or query of the row) take the split products of each 8-deep step into
// a fresh accumulator t and add it to d (two steps a t spilled at D = 64);
// the short ones over the head dim (S, dP) stay one chain.
__device__ __forceinline__ void add_frag(float (&d)[4], const float (&t)[4]) {
  d[0] += t[0];
  d[1] += t[1];
  d[2] += t[2];
  d[3] += t[3];
}

// a fragment of four TF32 values, as a value
struct SplitFrag {
  uint32_t r[4];
};

// the A operand of a split product from four fp32 values (a0..a3 order)
__device__ __forceinline__ void split_frag(float x0, float x1, float x2, float x3, uint32_t (&h)[4],
                                           uint32_t (&l)[4]) {
  split_tf32(x0, h[0], l[0]);
  split_tf32(x1, h[1], l[1]);
  split_tf32(x2, h[2], l[2]);
  split_tf32(x3, h[3], l[3]);
}

// ---- tiles
constexpr int kF32Rows = 64;      // the block's own rows: 4 warps x 16
constexpr int kF32Tile = 64;      // rows of a streamed tile
constexpr int kF32MaxSmem = 200 * 1024;  // the dynamic shared memory the fp32 kernels opt in to
constexpr int kPastEnd = -3;      // id of a streamed cell past the end of its row: matches nothing

// 16 bytes (4 bytes) global -> shared, zeros where `ok` is false (the source
// address must still be valid: the caller points it at the row's start)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// Start copying the 64-row tile at row0 of a (B, L, H, D) fp32 view into
// shared memory with row stride LD floats (rows past L read as zeros).
template <int D, int LD>
__device__ __forceinline__ void tile_async(float* dst, const float* __restrict__ base, Strides s, int b, int h,
                                           int row0, int L) {
  constexpr int CPR = D / 4;  // 16-byte pieces a row
  const float* head = base + (size_t)b * s.b + (size_t)h * s.h;
#pragma unroll
  for (int i = 0; i < kF32Tile * CPR / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads, r = c / CPR, cc = c % CPR;
    const bool ok = row0 + r < L;
    cp_async16_zfill(dst + r * LD + 4 * cc, head + (size_t)(ok ? row0 + r : 0) * s.l + 4 * cc, ok);
  }
}

// Threads 0..63: start copying one 32-bit value each of the tile at row0
// of a row of L values (an id row, or an lse / dl row), zeros past L.
__device__ __forceinline__ void row_async(void* dst, const void* __restrict__ row, int row0, int L) {
  if (threadIdx.x < kF32Tile) {
    const int p = row0 + threadIdx.x;
    cp_async4_zfill(static_cast<uint32_t*>(dst) + threadIdx.x, static_cast<const uint32_t*>(row) + (p < L ? p : 0),
                    p < L);
  }
}

// Threads 0..63, once their copy of the tile's ids (row_async) has landed:
// the ids as the attention kernels compare them (key_id / query_id), past
// the end kPastEnd.  SEG: segment ids as they are; padding masks: the
// streamed side's validity as key_id gives it (KEYS) or every query 0.
template <bool SEG, bool KEYS> __device__ __forceinline__ void ids_in_place(int* ids, int row0, int L) {
  if (threadIdx.x < kF32Tile) {
    const int raw = ids[threadIdx.x];
    const int id = SEG ? raw : (KEYS ? (__int_as_float(raw) > 0.f ? 0 : kNoKey) : 0);
    ids[threadIdx.x] = row0 + (int)threadIdx.x < L ? id : kPastEnd;
  }
}

// The range [lo, hi] of the ids of the block's valid own rows (each thread
// passes its two; with padding masks every id is 0), lo > hi when none is
// valid.  Every thread calls it; it holds one barrier.
__device__ __forceinline__ int2 block_id_range(bool v0, int id0, bool v1, int id1) {
  __shared__ int red[2][kThreads / 32];
  int lo = 0x7fffffff, hi = -0x7fffffff;
  if (v0) lo = min(lo, id0), hi = max(hi, id0);
  if (v1) lo = min(lo, id1), hi = max(hi, id1);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if ((threadIdx.x & 31) == 0) {
    red[0][threadIdx.x >> 5] = lo;
    red[1][threadIdx.x >> 5] = hi;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    lo = min(lo, red[0][w]);
    hi = max(hi, red[1][w]);
  }
  return make_int2(lo, hi);
}

// Flags each 64-row tile of the other axis (L cells, ids read as key_id
// reads them: segment ids, or 0 for a valid cell of a padding mask) whether
// it holds a cell whose id lies in r: every pair of the block outside such
// tiles is masked (or, for a padding query, has a zero cotangent).  A warp a
// tile, every flag written; the flags are read after the next barrier.
template <bool SEG>
__device__ __forceinline__ void flag_live_tiles(const void* ids, size_t base, int L, int2 r, unsigned char* live) {
  const int lane = threadIdx.x & 31, n = (L + kF32Tile - 1) / kF32Tile;
#pragma unroll 4
  for (int t = threadIdx.x >> 5; t < n; t += kThreads / 32) {
    const int p0 = t * kF32Tile + lane, p1 = p0 + 32;
    const int id0 = p0 < L ? key_id<SEG>(ids, base + p0) : kPastEnd;
    const int id1 = p1 < L ? key_id<SEG>(ids, base + p1) : kPastEnd;
    const bool hit = (id0 >= r.x && id0 <= r.y) || (id1 >= r.x && id1 <= r.y);
    const unsigned any = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) live[t] = any != 0u;
  }
}

// the first flagged tile at or after t (t if t >= n)
__device__ __forceinline__ int next_live(const unsigned char* live, int t, int n) {
  while (t < n && !live[t]) ++t;
  return t;
}

// The ring's tile sequence: the flagged tiles in order, NS - 1 of them in
// flight ahead of the one being computed (stage i % NS holds the i-th).
// Every thread keeps the same copy.
template <int NS> struct TileQueue {
  int pend[NS - 1];  // issued, oldest first
  int last = -1;     // the last tile looked at
  // the next flagged tile (n if none is left)
  __device__ __forceinline__ int advance(const unsigned char* live, int n) {
    last = next_live(live, last + 1, n);
    return last < n ? last : n;
  }
  __device__ __forceinline__ void push(int t) {
#pragma unroll
    for (int s = 0; s < NS - 2; ++s) pend[s] = pend[s + 1];
    pend[NS - 2] = t;
  }
};

}  // namespace srhep
