// Flash attention backward for Hopper (sm_90a): dq and dk, dv, recomputing
// the probabilities from the forward's base-2 log-sum-exp, for padding masks
// (K5, K6) and for segment-packed rows (K8, K9; template flag SEG, see
// common.cuh).
//
// Replaces the TPU kernels superresolutionhep_tpu/ops/flash_attention.py::
// _bwd_dq_kernel and ::_bwd_dkv_kernel (through _flash_bwd) with SEG = false,
// and superresolutionhep_tpu/ops/flash_packed.py::_packed_bwd_dq_kernel and
// ::_packed_bwd_dkv_kernel (through _packed_bwd) with SEG = true.  What they
// compute is kept:
//   * logits are base 2 (Q arrives pre-scaled by scale*log2(e)); padded keys
//     get the -1e30 bias;
//   * p = exp2(min(s - lse, 0)): the cap keeps a row whose LSE is ~-1e30 (a
//     dead query tile of the forward) finite; its cotangent is zero, so the
//     capped p never contributes;
//   * dp = g v^T, ds = p * (dp - dl) with dl = sum_d(out * g) from the caller;
//   * ds is cast to the input dtype before the dq and dk products, p to g's
//     dtype before the dv product; accumulation is fp32; outputs are in the
//     input dtype;
//   * a (query tile, key tile) pair without a valid key or without a valid
//     query is skipped (the JAX package's block_live);
//   * the cotangent arrives zeroed on padded queries, and the ln(2) of the
//     base-2 parametrisation is applied by the caller;
//   * packed (SEG): the masked pairs are those of different segments (padding
//     cells match each other; their zero cotangent keeps dq, dk, dv at padding
//     exactly 0), and only the band of tiles that can hold a cell of the
//     block's segments is visited: key tiles for dq, query tiles for dk/dv
//     (the TPU's band_ranges with the roles swapped).
//
// What is not carried over: the TPU's sequential innermost grid axis with a
// carry in scratch memory becomes a loop inside the block (dq: one block per
// batch row, head and query tile, looping over key tiles; dk/dv: one block
// per batch row, head and key tile, looping over query tiles).  No atomics:
// every output element is written by the one block that owns it, so the
// result is deterministic.  The transposed (B, H, D, L) layout becomes
// (B, L, H, D) views with D contiguous, as in the forward kernel, so the
// unfused path's q/k/v projections arrive without a copy.  The packed band is
// a table computed once per call for all heads at the kernel's own tiles
// (flash_attention.cu::packed_band_kernel, the same table for dq and dk/dv,
// since queries and keys share the segment ids), not fed in at 512-wide
// blocks as on the TPU: exact, so no segment-length cap can cut a segment
// short.
//
// What bounds it on the card: operations (dq: 3 products of 2*D flops per
// live (query, key) pair; dk/dv: 4 products), ~1000 flop per byte moved at
// L = 2048, D = 64 in bf16, far above the H100's ~295; beside them one exp2
// per pair on the special-function units and ~7 CUDA-core instructions per
// pair (the mask select, - lse, min, - dl, the multiply, the bf16 packs).
// The bf16 design (flash_bwd_{dq,dkv}_wgmma_kernel):
//   * a TMA-fed ring: NC consumer warpgroups of 64 rows each (NC = 2 for
//     large grids, so that each streamed tile serves 128 rows; NC = 1, two
//     blocks an SM, for small ones: ops/flash_attention.py::bwd_tile_rows).
//     The block's own rows are loaded once by TMA (K and V for dk/dv, Q and
//     G for dq: the A operands of S and dP, read from shared memory); the
//     other axis's tiles (Q and G with their lse and dl rows; K and V)
//     stream through a ring of mbarrier full/empty pairs, and the producer
//     alone decides their sequence, skipping dead tiles.  dq: a producer
//     warp of its own reads each key tile's ids four tiles ahead and writes
//     them into the stage.  dk/dv has no room for a producer warp (see
//     bwd_min_blocks): the block first marks its live query tiles (one bit
//     each), and thread 0 refills the ring between its own products by TMA
//     alone (segment ids too);
//   * dk/dv: S^T = K Q^T and dP^T = V G^T as wgmma.m64n64k16 from shared
//     memory; P^T and dS^T stay in registers, repacked to bf16 A fragments
//     for dV += P^T G and dK += dS^T Q with the streamed tile read MN-major
//     (as the forward's P V).  dq: S = Q K^T, dP = G V^T, dQ += dS K; lse
//     and dl of the block's own rows in registers;
//   * the elementwise part under the products: each consumer issues tile
//     j+1's S and dP before tile j's accumulating products and runs tile
//     j+1's elementwise part while those run; with two consumer warpgroups
//     they take turns to issue (named barriers), so that one's elementwise
//     part overlaps the other's products;
//   * the outputs leave in the input dtype through the block's own (no
//     longer needed) tiles as swizzled staging, one TMA store each.
// The fp32 build: dk/dv (flash_bwd_dkv_f32_kernel, four products) and dq
// (flash_bwd_dq_f32_kernel, three) take their products on the tensor cores
// as three-term TF32 splits (tf32_attention.cuh), on one design with the
// roles of the axes swapped, and find their band of streamed tiles
// themselves (a flag per tile); their sections say what holds them.
#include "common.cuh"
#include "tf32_attention.cuh"

namespace srhep {

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma.  Block = NC consumer warpgroups (64 rows each: queries
// for dq, keys for dk/dv; dq has one producer warp more).  In a consumer
// warpgroup, lane = 4*g + t of warp w
// holds rows 16w + g and 16w + g + 8 of the warpgroup's 64, columns 8j + 2t,
// 8j + 2t + 1 of every 8-wide slice (accumulator element 4j + e: e & 2 picks
// the row, e & 1 the column).
// ---------------------------------------------------------------------------
constexpr int kBwdBT = 64;         // rows of a streamed tile: one TMA box, the N of the S and dP products
constexpr int kBwdLookahead = 4;   // dq: key tiles whose ids the producer warp has in flight
constexpr bool kBwdTurns = true;   // two consumer warpgroups issue their products in turns
constexpr int kBwdMaxTiles = 2048; // dk/dv: query tiles whose liveness a block scans; past that, all count as live

// Ring depth: one block an SM (NC = 2) takes 7 stages, two blocks (NC = 1)
// 5 each.
template <int NC> __host__ __device__ constexpr int bwd_stages() { return NC == 1 ? 5 : 7; }

// Registers, not shared memory, shape the blocks: ptxas compiles a kernel to
// its launch bound's register budget (setmaxnreg does not raise it), and a
// block of 9-12 warps puts three warps on an SM sub-partition, which leaves
// at most 168 registers a thread.  dq fits that and has a producer warp of
// its own (NC consumer warpgroups + 1 warp); dk/dv needs ~240 (S^T and dP^T
// of one tile, P^T and dS^T of the one before, the dK and dV accumulators),
// so its blocks are 8 warps (NC = 2) or two blocks of 4 an SM, and thread 0
// feeds its ring between its own products.
template <int NC> constexpr int bwd_min_blocks() { return NC == 1 ? 2 : 1; }

// Dynamic shared memory, in bytes from a 1024-aligned base: the block's own
// rows (A: K for dk/dv, Q for dq; B: V, G; NC tiles each, at the end the
// outputs' staging), the ring of streamed tiles (A: Q for dk/dv, K for dq;
// B: G, V), with LSE (dk/dv) the stages' lse and dl rows, the stages' ids
// and tile indices, with LSE a bit per query tile (live or not), the
// barriers (full[NS], empty[NS], own rows).
template <int D, int NC, bool LSE> struct BwdSmem {
  static constexpr int kTile = FwdTiles<D>::kTileBytes, NS = bwd_stages<NC>(), kRow = kBwdBT * 4;
  static constexpr int kOwnA = 0, kOwnB = NC * kTile, kRingA = 2 * NC * kTile, kRingB = kRingA + NS * kTile;
  static constexpr int kLse = kRingB + NS * kTile;
  static constexpr int kDl = kLse + (LSE ? NS * kRow : 0);
  static constexpr int kIds = kDl + (LSE ? NS * kRow : 0);
  static constexpr int kTileIdx = kIds + NS * kRow;
  static constexpr int kBits = kTileIdx + 32;
  static constexpr int kBars = kBits + (LSE ? kBwdMaxTiles / 8 : 0);
  static constexpr int kBytes = 1024 + kBars + (2 * NS + 1) * 8;  // + 1024 of alignment slack
};

// wgmma descriptors of a 64-row tile, computed and pinned before the
// products' wgmma.fence (a register a wgmma reads, defined between its fence
// and its wait, makes ptxas serialise every wgmma of the kernel):
// K-major, the D/16 k-steps 32 bytes apart ...
template <int D> __device__ __forceinline__ void kmajor_descs(uint64_t (&d)[D / 16], uint32_t tile) {
  using T = FwdTiles<D>;
#pragma unroll
  for (int st = 0; st < D / 16; ++st) {
    d[st] = gmma_desc(tile + 32 * st, 8 * T::kRowBytes, T::kSwizzle);
    asm volatile("" : "+l"(d[st]));
  }
}
// ... and MN-major (the tile read as [k][n]), the 4 k-steps 16 rows apart
template <int D> __device__ __forceinline__ void mnmajor_descs(uint64_t (&d)[kBwdBT / 16], uint32_t tile) {
  using T = FwdTiles<D>;
#pragma unroll
  for (int kk = 0; kk < kBwdBT / 16; ++kk) {
    d[kk] = gmma_desc(tile + 16 * kk * T::kRowBytes, 8 * T::kRowBytes, T::kSwizzle);
    asm volatile("" : "+l"(d[kk]));
  }
}

// acc (64 x 64) = A (64 x D) B (64 x D)^T, both K-major: issued, not waited for
template <int D>
__device__ __forceinline__ void issue_abt(float (&acc)[kBwdBT / 2], const uint64_t (&a)[D / 16],
                                          const uint64_t (&b)[D / 16]) {
#pragma unroll
  for (int st = 0; st < D / 16; ++st) wgmma_ss_m64n64k16(acc, a[st], b[st], st);
}

// acc (64 x D) += P (64 x 64, bf16 A fragments) B (64 x D) with B MN-major
template <int D>
__device__ __forceinline__ void issue_pb(float (&acc)[D / 2], const uint32_t (&p)[kBwdBT / 4],
                                         const uint64_t (&b)[kBwdBT / 16]) {
#pragma unroll
  for (int kk = 0; kk < kBwdBT / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
    pv_mma<D>(acc, a, b[kk]);
  }
}

// The block's own rows: NC tiles each of the maps own_a and own_b from row
// row0, onto the `own` barrier (one thread)
template <int D, int NC, bool LSE>
__device__ __forceinline__ void load_own_rows(unsigned char* base, const CUtensorMap* own_a, const CUtensorMap* own_b,
                                              int row0, int h, int b) {
  using T = FwdTiles<D>;
  using M = BwdSmem<D, NC, LSE>;
  uint64_t* own = reinterpret_cast<uint64_t*>(base + M::kBars) + 2 * M::NS;
  mbar_arrive_expect_tx(own, 2 * NC * T::kTileBytes);
#pragma unroll
  for (int w = 0; w < NC; ++w) {
    tma_load_4d(base + M::kOwnA + w * T::kTileBytes, own_a, own, 0, row0 + 64 * w, h, b);
    tma_load_4d(base + M::kOwnB + w * T::kTileBytes, own_b, own, 0, row0 + 64 * w, h, b);
  }
}

// dq's producer warp: streams key tiles kt_first .. kt_last through the
// ring, throttled by it: each tile's key ids are read kBwdLookahead tiles
// ahead, a tile with no live key is skipped, and a live tile's ids and index
// go into its stage before lane 0 starts the TMA loads of its K and V.  A
// stage with index -1 ends the sequence.  The producer alone decides the
// sequence; the consumers follow the stages.
template <int D, int NC, bool SEG>
__device__ __forceinline__ void dq_produce(unsigned char* base, const CUtensorMap* tk, const CUtensorMap* tv,
                                           const void* kmask, int b, int h, int Lk, int kt_first, int kt_last) {
  using T = FwdTiles<D>;
  using M = BwdSmem<D, NC, false>;
  constexpr int NS = M::NS, IPL = kBwdBT / 32;  // ids per lane per tile
  int* ids = reinterpret_cast<int*>(base + M::kIds);
  int* tile = reinterpret_cast<int*>(base + M::kTileIdx);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + M::kBars);
  uint64_t* empty = full + NS;
  const int lane = threadIdx.x & 31;
  auto key = [&](int t, int c) {
    const int pos = t * kBwdBT + 32 * c + lane;
    return t <= kt_last && pos < Lk ? key_id<SEG>(kmask, (size_t)b * Lk + pos) : kNoKey;
  };
  int la[kBwdLookahead][IPL];
#pragma unroll
  for (int i = 0; i < kBwdLookahead; ++i)
#pragma unroll
    for (int c = 0; c < IPL; ++c) la[i][c] = key(kt_first + i, c);
  int stage = 0;
  unsigned phase = 0;
  for (int t = kt_first; t <= kt_last; ++t) {
    int id[IPL];
    bool live = false;
#pragma unroll
    for (int c = 0; c < IPL; ++c) {
      id[c] = la[0][c];
      live = live || id[c] >= 0;
    }
#pragma unroll
    for (int i = 0; i + 1 < kBwdLookahead; ++i)
#pragma unroll
      for (int c = 0; c < IPL; ++c) la[i][c] = la[i + 1][c];
#pragma unroll
    for (int c = 0; c < IPL; ++c) la[kBwdLookahead - 1][c] = key(t + kBwdLookahead, c);
    if (!__any_sync(0xffffffffu, live)) continue;  // no live key in this tile
    mbar_wait(&empty[stage], phase ^ 1);
#pragma unroll
    for (int c = 0; c < IPL; ++c) ids[stage * kBwdBT + 32 * c + lane] = id[c];
    if (lane == 0) {
      tile[stage] = t;
      mbar_arrive_expect_tx(&full[stage], 2 * T::kTileBytes);
      tma_load_4d(base + M::kRingA + stage * T::kTileBytes, tk, &full[stage], 0, t * kBwdBT, h, b);
      tma_load_4d(base + M::kRingB + stage * T::kTileBytes, tv, &full[stage], 0, t * kBwdBT, h, b);
    } else {
      mbar_arrive(&full[stage]);
    }
    if (++stage == NS) {
      stage = 0;
      phase ^= 1;
    }
  }
  mbar_wait(&empty[stage], phase ^ 1);  // the end of the sequence
  if (lane == 0) tile[stage] = -1;
  mbar_arrive(&full[stage]);
}

// dk/dv's feeder: thread 0, between its own products.  The block first marks
// which query tiles of qt_first .. qt_last hold a valid query (one bit each,
// all threads at once, while the own rows load); then each fill() puts the
// next such tile into the next stage of the ring, once every consumer has
// released the stage's previous tile, by TMA alone: Q and G, the tile's lse
// and dl rows, and with SEG its segment ids.  After the last live tile, a
// stage with index -1 ends the sequence.  The feeder alone decides the
// sequence; the consumers follow the stages.  It keeps NS - 2 stages filled
// ahead: a stage is released after its tile's last products and refilled
// two tiles later, so that it rarely waits for the other warpgroup.
template <int D, int NC, bool SEG> struct BwdQueryFeeder {
  using T = FwdTiles<D>;
  using M = BwdSmem<D, NC, true>;
  unsigned char* base;
  const CUtensorMap *tq, *tg, *tlse, *tdl, *tids;
  int b, h, H, next, last;
  bool all_live;
  int stage = 0;
  unsigned phase = 0;
  bool ended = false;

  __device__ __forceinline__ void fill() {
    if (ended) return;
    const uint32_t* bits = reinterpret_cast<const uint32_t*>(base + M::kBits);
    while (next <= last && !all_live && !((bits[next >> 5] >> (next & 31)) & 1u)) ++next;  // no valid query
    int* tile = reinterpret_cast<int*>(base + M::kTileIdx);
    uint64_t* full = reinterpret_cast<uint64_t*>(base + M::kBars);
    uint64_t* empty = full + M::NS;
    mbar_wait(&empty[stage], phase ^ 1);
    if (next <= last) {
      const int t = next++;
      tile[stage] = t;
      mbar_arrive_expect_tx(&full[stage], 2 * T::kTileBytes + (SEG ? 3 : 2) * kBwdBT * 4);
      tma_load_4d(base + M::kRingA + stage * T::kTileBytes, tq, &full[stage], 0, t * kBwdBT, h, b);
      tma_load_4d(base + M::kRingB + stage * T::kTileBytes, tg, &full[stage], 0, t * kBwdBT, h, b);
      tma_load_2d(base + M::kLse + stage * kBwdBT * 4, tlse, &full[stage], t * kBwdBT, b * H + h);
      tma_load_2d(base + M::kDl + stage * kBwdBT * 4, tdl, &full[stage], t * kBwdBT, b * H + h);
      if (SEG) tma_load_2d(base + M::kIds + stage * kBwdBT * 4, tids, &full[stage], t * kBwdBT, b);
    } else {  // the end of the sequence
      tile[stage] = -1;
      mbar_arrive(&full[stage]);
      ended = true;
    }
    if (++stage == M::NS) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// Turns of the consumer warpgroups (as in the forward kernel): each issues
// its products in turn (named barrier 1 + w: "warpgroup w may issue", passed
// on by the other after its own issue), so that one's elementwise part runs
// while the other's products hold the tensor cores.  Both take the same
// number of turns (the producer's sequence), and warpgroup 0 takes one more
// at the end to match the first pass that warpgroup NC - 1 gives it.
template <int NC> struct BwdTurns {
  static constexpr bool kOn = kBwdTurns && NC > 1;
  int wg;
  __device__ __forceinline__ void start() const {
    if (kOn && wg == NC - 1) named_bar_arrive(1, 128 * NC);
  }
  __device__ __forceinline__ void mine() const {
    if (kOn) named_bar_sync(1 + wg, 128 * NC);
  }
  __device__ __forceinline__ void pass() const {
    if (kOn) named_bar_arrive(1 + (wg + 1 == NC ? 0 : wg + 1), 128 * NC);
  }
  __device__ __forceinline__ void finish() const {
    if (kOn && wg == 0) named_bar_sync(1, 128 * NC);
  }
};

// dk/dv: s = S^T (this thread's key rows, kid0/kid1; the stage's query
// columns 8j + 2t, +1 with their lse and dl, and with SEG their segment ids)
// becomes P^T in place, dp = dP^T becomes dS^T = P^T * (dP^T - dl).  SEG:
// a pair of different segments is masked by a select (the logit becomes
// -1e30, which is what s - 1e30 rounds to for every finite logit below
// 1e22).  Padding masks need no pair mask here: a padded query's cotangent
// and dl are zero, so its column adds exactly 0 to dK and dV, and a padded
// key's row is zeroed at the end.
template <bool SEG>
__device__ __forceinline__ void dkv_tile_math(float (&s)[kBwdBT / 2], float (&dp)[kBwdBT / 2], const float* lse,
                                              const float* dl, const int* qid, int t, int kid0, int kid1) {
#pragma unroll
  for (int j = 0; j < kBwdBT / 8; ++j) {
    const int c = 8 * j + 2 * t;
    const float2 ls = *reinterpret_cast<const float2*>(lse + c);
    const float2 dd = *reinterpret_cast<const float2*>(dl + c);
    if (SEG) {
      const int2 id = *reinterpret_cast<const int2*>(qid + c);
      s[4 * j] = id.x == kid0 ? s[4 * j] : kNegInf;
      s[4 * j + 1] = id.y == kid0 ? s[4 * j + 1] : kNegInf;
      s[4 * j + 2] = id.x == kid1 ? s[4 * j + 2] : kNegInf;
      s[4 * j + 3] = id.y == kid1 ? s[4 * j + 3] : kNegInf;
    }
    s[4 * j] = ex2(fminf(s[4 * j] - ls.x, 0.f));
    s[4 * j + 1] = ex2(fminf(s[4 * j + 1] - ls.y, 0.f));
    s[4 * j + 2] = ex2(fminf(s[4 * j + 2] - ls.x, 0.f));
    s[4 * j + 3] = ex2(fminf(s[4 * j + 3] - ls.y, 0.f));
    dp[4 * j] = s[4 * j] * (dp[4 * j] - dd.x);
    dp[4 * j + 1] = s[4 * j + 1] * (dp[4 * j + 1] - dd.y);
    dp[4 * j + 2] = s[4 * j + 2] * (dp[4 * j + 2] - dd.x);
    dp[4 * j + 3] = s[4 * j + 3] * (dp[4 * j + 3] - dd.y);
  }
}

// dq: s = S (this thread's query rows, qid0/qid1 with their lse and dl; the
// stage's key columns 8j + 2t, +1 with their ids) becomes dS = P * (dP - dl)
// in place.
__device__ __forceinline__ void dq_tile_math(float (&s)[kBwdBT / 2], const float (&dp)[kBwdBT / 2], const int* kid,
                                             int t, int qid0, int qid1, float lse0, float lse1, float dl0, float dl1) {
#pragma unroll
  for (int j = 0; j < kBwdBT / 8; ++j) {
    const int2 id = *reinterpret_cast<const int2*>(kid + 8 * j + 2 * t);
    s[4 * j] = ex2(fminf((id.x == qid0 ? s[4 * j] : kNegInf) - lse0, 0.f)) * (dp[4 * j] - dl0);
    s[4 * j + 1] = ex2(fminf((id.y == qid0 ? s[4 * j + 1] : kNegInf) - lse0, 0.f)) * (dp[4 * j + 1] - dl0);
    s[4 * j + 2] = ex2(fminf((id.x == qid1 ? s[4 * j + 2] : kNegInf) - lse1, 0.f)) * (dp[4 * j + 2] - dl1);
    s[4 * j + 3] = ex2(fminf((id.y == qid1 ? s[4 * j + 3] : kNegInf) - lse1, 0.f)) * (dp[4 * j + 3] - dl1);
  }
}

// A consumer warpgroup's 64 x D fp32 accumulator into a 64-row bf16 tile of
// shared memory in the TMA's swizzled layout (the staging of a TMA store)
template <int D>
__device__ __forceinline__ void stage_acc(uint32_t tile, const float (&acc)[D / 2], int warp, int g, int t) {
  const int rl = 16 * warp + g;
#pragma unroll
  for (int jd = 0; jd < D / 8; ++jd) {
    const int c = 8 * jd + 2 * t;
    sts_u32(tile + swz_tile_offset<D>(rl, c), pack_bf16(acc[4 * jd], acc[4 * jd + 1]));
    sts_u32(tile + swz_tile_offset<D>(rl + 8, c), pack_bf16(acc[4 * jd + 2], acc[4 * jd + 3]));
  }
}

// zeros into rows row0 .. row0 + rows - 1 (those below L) of a contiguous
// (B, L, H, D) bf16 output: a block with no live row
template <int D>
__device__ __forceinline__ void zero_rows(bf16* __restrict__ out, int b, int h, int H, int L, int row0, int rows) {
  constexpr int V16 = D / 8;  // 16-byte pieces per row
  for (int c = threadIdx.x; c < rows * V16; c += blockDim.x) {
    const int r = row0 + c / V16;
    if (r < L) *reinterpret_cast<uint4*>(out + (((size_t)b * L + r) * H + h) * D + 8 * (c % V16)) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// ---------------------------------------------------------------------------
// bf16, K6 / K9: dk and dv.  q, k, v, g: tensor maps over (D, L, H, B) with
// box (D, 64, 1, 1); lse, dl: maps over (Lq, B * H) with box (64, 1); dk, dv:
// maps over the contiguous outputs; ids (SEG): a map over the segment ids
// (S, B) with box (64, 1); band (SEG): (B, gridDim.x, 2) int32 = (first
// query tile, count) per key block.
// ---------------------------------------------------------------------------
template <int D, bool SEG, int NC>
__global__ void __launch_bounds__(128 * NC, bwd_min_blocks<NC>())
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tg,
                           const __grid_constant__ CUtensorMap tlse, const __grid_constant__ CUtensorMap tdl,
                           const __grid_constant__ CUtensorMap tdk, const __grid_constant__ CUtensorMap tdv,
                           const __grid_constant__ CUtensorMap tids, const void* __restrict__ qmask,
                           const void* __restrict__ kmask,
                           const int* __restrict__ band, bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Lq,
                           int Lk) {
  using T = FwdTiles<D>;
  using M = BwdSmem<D, NC, true>;
  constexpr int BR = 64 * NC, NS = bwd_stages<NC>();
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment: the period of the 128-byte swizzle, which TMA and wgmma both apply by address
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int* ids = reinterpret_cast<const int*>(base + M::kIds);
  const int* tile = reinterpret_cast<const int*>(base + M::kTileIdx);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + M::kBars);
  uint64_t* empty = full + NS;
  uint64_t* own = empty + NS;

  const int tid = threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, k0 = blockIdx.x * BR;
  uint32_t* live_bits = reinterpret_cast<uint32_t*>(base + M::kBits);
  bool row_live = false;
  if (tid < BR) row_live = k0 + tid < Lk && key_id<SEG>(kmask, (size_t)b * Lk + k0 + tid) >= 0;
  if (tid < kBwdMaxTiles / 32) live_bits[tid] = 0u;
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 1);          // the feeder (it also brings the TMA bytes)
      mbar_init(&empty[s], 128 * NC);  // every consumer thread
    }
    mbar_init(own, 1);
    fence_mbar_init();
  }
  if (!__syncthreads_or(row_live)) {  // block-uniform: no live key, so dk = dv = 0; no barrier is waited on
    zero_rows<D>(dk, b, h, H, Lk, k0, BR);
    zero_rows<D>(dv, b, h, H, Lk, k0, BR);
    return;
  }

  // warp-uniform as far as the compiler can see, so that the wgmma
  // descriptors derived from it live in uniform registers
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int warp = (tid % 128) >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  int qt_first = 0, qt_last = (Lq + kBwdBT - 1) / kBwdBT - 1;
  if (SEG) {
    const int2 bd = *reinterpret_cast<const int2*>(band + 2 * ((size_t)b * gridDim.x + blockIdx.x));
    qt_first = bd.x;
    qt_last = bd.x + bd.y - 1;
  }
  if (tid == 0) load_own_rows<D, NC, true>(base, &tk, &tv, k0, h, b);
  // while the own rows load: a bit for each query tile with a valid query
  const bool all_live = (Lq + kBwdBT - 1) / kBwdBT > kBwdMaxTiles;
  if (!all_live) {
    for (int qt = qt_first + (tid >> 5); qt <= qt_last; qt += 4 * NC) {
      bool v = false;
#pragma unroll
      for (int c = 0; c < kBwdBT / 32; ++c) {
        const int pos = qt * kBwdBT + 32 * c + lane;
        v = v || (pos < Lq && query_valid<SEG>(qmask, (size_t)b * Lq + pos));
      }
      if (__any_sync(0xffffffffu, v) && lane == 0) atomicOr(&live_bits[qt >> 5], 1u << (qt & 31));
    }
  }
  __syncthreads();
  BwdQueryFeeder<D, NC, SEG> feed{base, &tq, &tg, &tlse, &tdl, &tids, b, h, H, qt_first, qt_last, all_live};
  if (tid == 0)
    for (int i = 0; i < NS - 2; ++i) feed.fill();
  const int r0 = k0 + 64 * wg + 16 * warp + g, r1 = r0 + 8;
  const int kid0 = r0 < Lk ? key_id<SEG>(kmask, (size_t)b * Lk + r0) : kNoKey;
  const int kid1 = r1 < Lk ? key_id<SEG>(kmask, (size_t)b * Lk + r1) : kNoKey;
  const float* lses = reinterpret_cast<const float*>(base + M::kLse);
  const float* dls = reinterpret_cast<const float*>(base + M::kDl);
  const uint32_t ka = smem_u32(base + M::kOwnA + wg * T::kTileBytes), va = smem_u32(base + M::kOwnB + wg * T::kTileBytes);
  const uint32_t qs0 = smem_u32(base + M::kRingA), gs0 = smem_u32(base + M::kRingB);

  float dka[D / 2], dva[D / 2], s[kBwdBT / 2], dp[kBwdBT / 2];
  uint32_t pp[kBwdBT / 4], pd[kBwdBT / 4];  // P^T and dS^T as bf16 A fragments
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
  const BwdTurns<NC> turn{wg};
  turn.start();

  mbar_wait(own, 0);
  int stage = 0;
  unsigned phase = 0;
  mbar_wait(&full[0], 0);
  if (tile[0] >= 0) {
    {  // S^T and dP^T of the first tile, its elementwise part
      uint64_t da[D / 16], db[D / 16], dc[D / 16], dd[D / 16];
      kmajor_descs<D>(da, ka);
      kmajor_descs<D>(db, qs0);
      kmajor_descs<D>(dc, va);
      kmajor_descs<D>(dd, gs0);
      turn.mine();
      wgmma_fence();
      issue_abt<D>(s, da, db);   // S^T  = K Q^T
      issue_abt<D>(dp, dc, dd);  // dP^T = V G^T
      wgmma_commit();
      turn.pass();
      wgmma_wait<0>();
      fence_operand(s);
      fence_operand(dp);
    }
    dkv_tile_math<SEG>(s, dp, lses, dls, ids, t, kid0, kid1);
    pack_p(s, pp);
    pack_p(dp, pd);
    // every further tile: its S^T and dP^T issued before the previous
    // tile's dV and dK products, its elementwise part while those run.  The
    // loop body holds no branch between an issue and its wait.
    while (true) {
      const int ns = stage + 1 == NS ? 0 : stage + 1;
      const unsigned nph = ns == 0 ? phase ^ 1 : phase;
      mbar_wait(&full[ns], nph);
      if (tile[ns] < 0) break;
      uint64_t da[D / 16], db[D / 16], dc[D / 16], dd[D / 16], gm[kBwdBT / 16], qm[kBwdBT / 16];
      kmajor_descs<D>(da, ka);
      kmajor_descs<D>(db, qs0 + ns * T::kTileBytes);
      kmajor_descs<D>(dc, va);
      kmajor_descs<D>(dd, gs0 + ns * T::kTileBytes);
      mnmajor_descs<D>(gm, gs0 + stage * T::kTileBytes);  // this tile's G and Q, read as [query][d]
      mnmajor_descs<D>(qm, qs0 + stage * T::kTileBytes);
      fence_operand(s);
      fence_operand(dp);
      fence_operand(dka);
      fence_operand(dva);
      fence_operand(pp);
      fence_operand(pd);
      turn.mine();
      wgmma_fence();
      issue_abt<D>(s, da, db);
      issue_abt<D>(dp, dc, dd);
      wgmma_commit();
      issue_pb<D>(dva, pp, gm);  // dV += P^T G
      issue_pb<D>(dka, pd, qm);  // dK += dS^T Q
      wgmma_commit();
      turn.pass();
      if (tid == 0) feed.fill();
      wgmma_wait<1>();
      fence_operand(s);
      fence_operand(dp);
      dkv_tile_math<SEG>(s, dp, lses + ns * kBwdBT, dls + ns * kBwdBT, ids + ns * kBwdBT, t, kid0, kid1);
      wgmma_wait<0>();
      fence_operand(dka);
      fence_operand(dva);
      fence_operand(pp);
      fence_operand(pd);
      mbar_arrive(&empty[stage]);
      pack_p(s, pp);
      pack_p(dp, pd);
      stage = ns;
      phase = nph;
    }
    {  // the last tile's dV and dK products
      uint64_t gm[kBwdBT / 16], qm[kBwdBT / 16];
      mnmajor_descs<D>(gm, gs0 + stage * T::kTileBytes);
      mnmajor_descs<D>(qm, qs0 + stage * T::kTileBytes);
      fence_operand(dka);
      fence_operand(dva);
      fence_operand(pp);
      fence_operand(pd);
      turn.mine();
      wgmma_fence();
      issue_pb<D>(dva, pp, gm);
      issue_pb<D>(dka, pd, qm);
      wgmma_commit();
      turn.pass();
      wgmma_wait<0>();
      fence_operand(dka);
      fence_operand(dva);
    }
  }
  turn.finish();

  // a key row that is no live key (padding) gets exactly 0
#pragma unroll
  for (int i = 0; i < D / 2; i += 4) {
    if (kid0 < 0) dka[i] = dka[i + 1] = dva[i] = dva[i + 1] = 0.f;
    if (kid1 < 0) dka[i + 2] = dka[i + 3] = dva[i + 2] = dva[i + 3] = 0.f;
  }
  // dK and dV in the input dtype: staged in the warpgroup's own K and V
  // tiles (no wgmma reads them any more) in the TMA's swizzled layout, then
  // one TMA store each (rows past Lk are not written)
  stage_acc<D>(ka, dka, warp, g, t);
  stage_acc<D>(va, dva, warp, g, t);
  fence_proxy_async();
  named_bar_sync(3 + wg, 128);
  if (tid % 128 == 0) {
    tma_store_4d(&tdk, ka, 0, k0 + 64 * wg, h, b);
    tma_store_4d(&tdv, va, 0, k0 + 64 * wg, h, b);
    bulk_commit();
    bulk_wait_read<0>();
  }
}

// ---------------------------------------------------------------------------
// bf16, K5 / K8: dq.  Maps as for dk/dv (dq over the contiguous output); lse,
// dl (B, H, ldr) fp32, read per own row; band (SEG): (B, gridDim.x, 2) int32
// = (first key tile, count) per query block.
// ---------------------------------------------------------------------------
template <int D, bool SEG, int NC>
__global__ void __launch_bounds__(128 * NC + 32, bwd_min_blocks<NC>())
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tg,
                          const __grid_constant__ CUtensorMap tdq, const float* __restrict__ lse,
                          const float* __restrict__ dl, const void* __restrict__ qmask,
                          const void* __restrict__ kmask, const int* __restrict__ band, bf16* __restrict__ dq, int H,
                          int Lq, int Lk, int ldr) {
  using T = FwdTiles<D>;
  using M = BwdSmem<D, NC, false>;
  constexpr int BR = 64 * NC, NS = bwd_stages<NC>();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int* ids = reinterpret_cast<const int*>(base + M::kIds);
  const int* tile = reinterpret_cast<const int*>(base + M::kTileIdx);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + M::kBars);
  uint64_t* empty = full + NS;
  uint64_t* own = empty + NS;

  const int tid = threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * BR;
  bool row_live = false;
  if (tid < BR) row_live = q0 + tid < Lq && query_valid<SEG>(qmask, (size_t)b * Lq + q0 + tid);
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], 128 * NC);
    }
    mbar_init(own, 1);
    fence_mbar_init();
  }
  if (!__syncthreads_or(row_live)) {  // block-uniform: no valid query, so dq = 0
    zero_rows<D>(dq, b, h, H, Lq, q0, BR);
    return;
  }

  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  const int warp = (tid % 128) >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  if (wg == NC) {  // the producer warp
    int kt_first = 0, kt_last = (Lk + kBwdBT - 1) / kBwdBT - 1;
    if (SEG) {
      const int2 bd = *reinterpret_cast<const int2*>(band + 2 * ((size_t)b * gridDim.x + blockIdx.x));
      kt_first = bd.x;
      kt_last = bd.x + bd.y - 1;
    }
    if (lane == 0) load_own_rows<D, NC, false>(base, &tq, &tg, q0, h, b);
    dq_produce<D, NC, SEG>(base, &tk, &tv, kmask, b, h, Lk, kt_first, kt_last);
    return;
  }
  const int r0 = q0 + 64 * wg + 16 * warp + g, r1 = r0 + 8;
  const int qid0 = r0 < Lq ? query_id<SEG>(qmask, (size_t)b * Lq + r0) : kPadSeg;
  const int qid1 = r1 < Lq ? query_id<SEG>(qmask, (size_t)b * Lq + r1) : kPadSeg;
  const size_t rb = ((size_t)b * H + h) * ldr;
  const float lse0 = r0 < Lq ? lse[rb + r0] : 0.f, lse1 = r1 < Lq ? lse[rb + r1] : 0.f;
  const float dl0 = r0 < Lq ? dl[rb + r0] : 0.f, dl1 = r1 < Lq ? dl[rb + r1] : 0.f;
  const uint32_t qa = smem_u32(base + M::kOwnA + wg * T::kTileBytes), ga = smem_u32(base + M::kOwnB + wg * T::kTileBytes);
  const uint32_t ks0 = smem_u32(base + M::kRingA), vs0 = smem_u32(base + M::kRingB);

  float dqa[D / 2], s[kBwdBT / 2], dp[kBwdBT / 2];
  uint32_t pd[kBwdBT / 4];  // dS as bf16 A fragments
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
  const BwdTurns<NC> turn{wg};
  turn.start();

  mbar_wait(own, 0);
  int stage = 0;
  unsigned phase = 0;
  mbar_wait(&full[0], 0);
  if (tile[0] >= 0) {
    {  // S and dP of the first tile, its elementwise part
      uint64_t da[D / 16], db[D / 16], dc[D / 16], dd[D / 16];
      kmajor_descs<D>(da, qa);
      kmajor_descs<D>(db, ks0);
      kmajor_descs<D>(dc, ga);
      kmajor_descs<D>(dd, vs0);
      turn.mine();
      wgmma_fence();
      issue_abt<D>(s, da, db);   // S  = Q K^T
      issue_abt<D>(dp, dc, dd);  // dP = G V^T
      wgmma_commit();
      turn.pass();
      wgmma_wait<0>();
      fence_operand(s);
      fence_operand(dp);
    }
    dq_tile_math(s, dp, ids, t, qid0, qid1, lse0, lse1, dl0, dl1);
    pack_p(s, pd);
    while (true) {
      const int ns = stage + 1 == NS ? 0 : stage + 1;
      const unsigned nph = ns == 0 ? phase ^ 1 : phase;
      mbar_wait(&full[ns], nph);
      if (tile[ns] < 0) break;
      uint64_t da[D / 16], db[D / 16], dc[D / 16], dd[D / 16], km[kBwdBT / 16];
      kmajor_descs<D>(da, qa);
      kmajor_descs<D>(db, ks0 + ns * T::kTileBytes);
      kmajor_descs<D>(dc, ga);
      kmajor_descs<D>(dd, vs0 + ns * T::kTileBytes);
      mnmajor_descs<D>(km, ks0 + stage * T::kTileBytes);  // this tile's K, read as [key][d]
      fence_operand(s);
      fence_operand(dp);
      fence_operand(dqa);
      fence_operand(pd);
      turn.mine();
      wgmma_fence();
      issue_abt<D>(s, da, db);
      issue_abt<D>(dp, dc, dd);
      wgmma_commit();
      issue_pb<D>(dqa, pd, km);  // dQ += dS K
      wgmma_commit();
      turn.pass();
      wgmma_wait<1>();
      fence_operand(s);
      fence_operand(dp);
      dq_tile_math(s, dp, ids + ns * kBwdBT, t, qid0, qid1, lse0, lse1, dl0, dl1);
      wgmma_wait<0>();
      fence_operand(dqa);
      fence_operand(pd);
      mbar_arrive(&empty[stage]);
      pack_p(s, pd);
      stage = ns;
      phase = nph;
    }
    {  // the last tile's dQ product
      uint64_t km[kBwdBT / 16];
      mnmajor_descs<D>(km, ks0 + stage * T::kTileBytes);
      fence_operand(dqa);
      fence_operand(pd);
      turn.mine();
      wgmma_fence();
      issue_pb<D>(dqa, pd, km);
      wgmma_commit();
      turn.pass();
      wgmma_wait<0>();
      fence_operand(dqa);
    }
  }
  turn.finish();

  // dQ in the input dtype through the warpgroup's own Q tile, one TMA store
  stage_acc<D>(qa, dqa, warp, g, t);
  fence_proxy_async();
  named_bar_sync(3 + wg, 128);
  if (tid % 128 == 0) {
    tma_store_4d(&tdq, qa, 0, q0 + 64 * wg, h, b);
    bulk_commit();
    bulk_wait_read<0>();
  }
}


// ---------------------------------------------------------------------------
// fp32 dk/dv (K6, K9 on fp32 operands: PF training, SR training at "default"
// precision): the four products on the tensor cores as three-term TF32
// splits (tf32_attention.cuh), fp32-faithful, deterministic (no atomics).
//
// What bounds it: at D = 16 (PF) the least time is the split products (3
// TF32 products for each of the 8*D flops a pair, ~15 us at (32, 640, 4,
// 16)); beside them every Q and G value of a streamed tile is read and split
// by each warp twice, once in each of the two orders the products read it
// (as the B operand of S^T = K Q^T and dP^T = V G^T, and of dV += P^T G and
// dK += dS^T Q), P^T and dS^T are split once each, and the elementwise part
// (mask select, - lse, min, exp2, - dl, multiply) runs beside one exp2 a
// pair.  As in the forward, the products' mma.sync rate and the splits'
// instruction issue hold it (PERF.md §6).  The design: a block of 4
// warps owns 64 key rows; their K and V A fragments are stored raw once in
// shared memory in fragment order (one 16-byte read a k-step; registers hold
// the four accumulators instead) and split per tile; Q and G tiles with
// their lse, dl and query ids stream through a two-stage cp.async ring (one
// barrier a tile) whose rows (D + 4 floats) make the reads in both orders
// free of bank conflicts; P^T and dS^T go from the accumulators into the A
// operands of dV and dK with no shuffle (G's and Q's rows read in the
// matching order, tf32_attention.cuh); each 8-query step of dK and dV is
// summed apart and added in fp32 (add_frag); at D = 64 a tile goes in two
// halves of 32 queries (registers); only query tiles with a query of the
// block's key ids are visited.
// ---------------------------------------------------------------------------
constexpr int kDkvTerms = 3;  // terms of each split product (1: single TF32)

// The fp32 backward kernels' dynamic shared memory (dk/dv: ROWS = 3, OWN =
// 2; dq: ROWS = 1, OWN = 2 or 4): OWN arrays of A fragments of the block's
// own rows (dk/dv: K, V; dq: Q, G raw, or each split into hi and lo); a ring
// of stages, each a tile of the two streamed operands (dk/dv: Q, G; dq: K,
// V) and ROWS rows of 64 32-bit values (dk/dv: lse, dl, query ids; dq: key
// ids); a flag per streamed tile.
template <int D, int ROWS, int OWN> struct BwdF32 {
  static constexpr int kStages = 2;  // ring depth: deeper rings gained nothing (PERF.md)
  static constexpr int kLd = D + 4;  // streamed rows: 4-byte reads at (g, t) and at (2t, g) hit distinct banks
  static constexpr int kOwnBytes = OWN * kF32Rows * D * 4;
  static constexpr int kTileBytes = kF32Tile * kLd * 4;
  static constexpr int kStageBytes = 2 * kTileBytes + ROWS * kF32Tile * 4;
  static constexpr int smem_bytes(int n_tiles) {
    return kOwnBytes + kStages * kStageBytes + ((n_tiles + 15) & ~15);
  }
};

// q, k, v, g: (B, L, H, D) fp32 views with D contiguous; lse, dl (B, H, Lq);
// one block per (key tile of 64, head, batch row); dynamic shared memory
// BwdF32<D, 3, 2>::smem_bytes.
template <int D, bool SEG>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                         const float* __restrict__ g, const float* __restrict__ lse, const float* __restrict__ dl,
                         const void* __restrict__ qmask, const void* __restrict__ kmask, float* __restrict__ dk,
                         float* __restrict__ dv, int H, int Lq, int Lk, Strides qs, Strides ks, Strides vs,
                         Strides gs) {
  using T = BwdF32<D, 3, 2>;
  constexpr int KS = D / 8, NT = D / 8, NJ = kF32Tile / 8;  // k-steps over D, output n-tiles, query n-tiles
  // query steps a pass takes: at D = 64 a tile goes in two halves of 32
  // queries (S^T and dP^T for 64 queries beside the dK, dV accumulators spilled)
  constexpr int NJS = D == 64 ? NJ / 2 : NJ;
  constexpr int NS = T::kStages;
  // S^T and dP^T: the k-steps one at a time below D = 64 (fully unrolled,
  // ptxas capped those builds at 128 and 168 registers and spilled)
  constexpr int kUnrollS = D == 64 ? KS : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float4* own = reinterpret_cast<float4*>(smem);  // [K, V][warp][k-step][lane]
  unsigned char* ring = smem + T::kOwnBytes;
  unsigned char* live = ring + NS * T::kStageBytes;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z, nqt = (Lq + kF32Tile - 1) / kF32Tile;
  const int r0 = blockIdx.x * kF32Rows + warp * 16 + gq, r1 = r0 + 8;  // this thread's key rows
  const bool in0 = r0 < Lk, in1 = r1 < Lk;
  const int kid0 = in0 ? key_id<SEG>(kmask, (size_t)b * Lk + r0) : kNoKey;
  const int kid1 = in1 ? key_id<SEG>(kmask, (size_t)b * Lk + r1) : kNoKey;
  // this thread's A fragments of K and V (rows r0, r1; head-dim columns
  // 8kk + t, 8kk + t + 4), raw, into its own slots (before the first
  // barrier, so that the loads' latency overlaps it)
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const float* k0p = k + (size_t)b * ks.b + (size_t)(in0 ? r0 : 0) * ks.l + (size_t)h * ks.h + 8 * kk + tq;
    const float* k1p = k + (size_t)b * ks.b + (size_t)(in1 ? r1 : 0) * ks.l + (size_t)h * ks.h + 8 * kk + tq;
    const float* v0p = v + (size_t)b * vs.b + (size_t)(in0 ? r0 : 0) * vs.l + (size_t)h * vs.h + 8 * kk + tq;
    const float* v1p = v + (size_t)b * vs.b + (size_t)(in1 ? r1 : 0) * vs.l + (size_t)h * vs.h + 8 * kk + tq;
    own[(warp * KS + kk) * 32 + lane] =
        make_float4(in0 ? k0p[0] : 0.f, in1 ? k1p[0] : 0.f, in0 ? k0p[4] : 0.f, in1 ? k1p[4] : 0.f);
    own[((4 + warp) * KS + kk) * 32 + lane] =
        make_float4(in0 ? v0p[0] : 0.f, in1 ? v1p[0] : 0.f, in0 ? v0p[4] : 0.f, in1 ? v1p[4] : 0.f);
  }
  // padding masks: a query tile is live if it holds a valid query (the others' cotangent is zero)
  if (!SEG) flag_live_tiles<SEG>(qmask, (size_t)b * Lq, Lq, make_int2(0, 0), live);
  const int2 ids = block_id_range(kid0 >= 0, kid0, kid1 >= 0, kid1);

  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[nt][e] = dva[nt][e] = 0.f;

  if (ids.x <= ids.y) {
    if (SEG) {  // segments: a query tile is live if it holds a query of the block's segments
      flag_live_tiles<SEG>(qmask, (size_t)b * Lq, Lq, ids, live);
      __syncthreads();
    }
    auto stage = [&](int s) { return ring + s * T::kStageBytes; };
    auto issue = [&](int s, int qt) {
      unsigned char* st = stage(s);
      const int q0 = qt * kF32Tile;
      const size_t rb = ((size_t)b * H + h) * Lq;
      tile_async<D, T::kLd>(reinterpret_cast<float*>(st), q, qs, b, h, q0, Lq);
      tile_async<D, T::kLd>(reinterpret_cast<float*>(st + T::kTileBytes), g, gs, b, h, q0, Lq);
      row_async(st + 2 * T::kTileBytes, lse + rb, q0, Lq);
      row_async(st + 2 * T::kTileBytes + kF32Tile * 4, dl + rb, q0, Lq);
      row_async(st + 2 * T::kTileBytes + 2 * kF32Tile * 4, static_cast<const unsigned char*>(qmask) + (size_t)b * Lq * 4,
                q0, Lq);
    };
    TileQueue<NS> tq_;
#pragma unroll
    for (int s = 0; s < NS - 1; ++s) {
      tq_.pend[s] = tq_.advance(live, nqt);
      if (tq_.pend[s] < nqt) issue(s, tq_.pend[s]);
      cp_async_commit();
    }
    for (int i = 0; tq_.pend[0] < nqt; ++i) {
      const int cur = tq_.pend[0], s = i % NS;
      cp_async_wait<NS - 2>();  // this thread's copies of tile i have landed
      unsigned char* st = stage(s);
      const float* Qs = reinterpret_cast<const float*>(st);
      const float* Gs = reinterpret_cast<const float*>(st + T::kTileBytes);
      const float* lses = reinterpret_cast<const float*>(st + 2 * T::kTileBytes);
      const float* dls = lses + kF32Tile;
      int* qid = reinterpret_cast<int*>(st + 2 * T::kTileBytes + 2 * kF32Tile * 4);
      ids_in_place<SEG, false>(qid, cur * kF32Tile, Lq);
      __syncthreads();
      // one barrier a tile: tile i is visible, and every warp is past tile
      // i - 1, whose stage takes the copy of tile i + NS - 1
      const int nxt = tq_.advance(live, nqt);
      if (nxt < nqt) issue((i + NS - 1) % NS, nxt);
      cp_async_commit();

#pragma unroll 1
      for (int sub = 0; sub < NJ / NJS; ++sub) {  // a loop: unrolled, ptxas hoisted the halves into each other and spilled
        const int j0 = sub * NJS;
        // ---- S^T = K Q^T and dP^T = V G^T: 16 keys x 8 NJS queries a warp
        // (c: key rows g, g+8; queries 8(j0 + j) + 2t, +1)
        float st_[NJS][4], dpt[NJS][4];
#pragma unroll
        for (int j = 0; j < NJS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) st_[j][e] = dpt[j][e] = 0.f;
#pragma unroll kUnrollS
        for (int kk = 0; kk < KS; ++kk) {
          const float4 ka = own[(warp * KS + kk) * 32 + lane], va = own[((4 + warp) * KS + kk) * 32 + lane];
          uint32_t kh[4], kl[4], vh[4], vl[4];
          split_frag(ka.x, ka.y, ka.z, ka.w, kh, kl);
          split_frag(va.x, va.y, va.z, va.w, vh, vl);
#pragma unroll
          for (int j = 0; j < NJS; ++j) {
            const int o = (8 * (j0 + j) + gq) * T::kLd + 8 * kk + tq;
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(Qs[o], bh0, bl0);
            split_tf32(Qs[o + 4], bh1, bl1);
            mma_split<kDkvTerms>(st_[j], kh, kl, bh0, bh1, bl0, bl1);
            split_tf32(Gs[o], bh0, bl0);
            split_tf32(Gs[o + 4], bh1, bl1);
            mma_split<kDkvTerms>(dpt[j], vh, vl, bh0, bh1, bl0, bl1);
          }
        }

        // ---- P^T = exp2(min(s - lse, 0)) on live pairs, dS^T = P^T (dP^T - dl)
#pragma unroll
        for (int j = 0; j < NJS; ++j) {
          const int c = 8 * (j0 + j) + 2 * tq;
          const int2 id = *reinterpret_cast<const int2*>(qid + c);
          const float2 lc = *reinterpret_cast<const float2*>(lses + c);
          const float2 dlc = *reinterpret_cast<const float2*>(dls + c);
          const float p0 = ex2(fminf((id.x == kid0 ? st_[j][0] : kNegInf) - lc.x, 0.f));
          const float p1 = ex2(fminf((id.y == kid0 ? st_[j][1] : kNegInf) - lc.y, 0.f));
          const float p2 = ex2(fminf((id.x == kid1 ? st_[j][2] : kNegInf) - lc.x, 0.f));
          const float p3 = ex2(fminf((id.y == kid1 ? st_[j][3] : kNegInf) - lc.y, 0.f));
          dpt[j][0] = p0 * (dpt[j][0] - dlc.x);
          dpt[j][1] = p1 * (dpt[j][1] - dlc.y);
          dpt[j][2] = p2 * (dpt[j][2] - dlc.x);
          dpt[j][3] = p3 * (dpt[j][3] - dlc.y);
          st_[j][0] = p0;
          st_[j][1] = p1;
          st_[j][2] = p2;
          st_[j][3] = p3;
        }

        // ---- dV += P^T G, dK += dS^T Q: the accumulators are the A operands
        // (queries 8j + 2t, +1), G's and Q's rows read in that order
#pragma unroll
        for (int j = 0; j < NJS; ++j) {
          uint32_t ph[4], pl[4], dh[4], dlo[4];
          split_frag(st_[j][0], st_[j][2], st_[j][1], st_[j][3], ph, pl);
          split_frag(dpt[j][0], dpt[j][2], dpt[j][1], dpt[j][3], dh, dlo);
          const int o = (8 * (j0 + j) + 2 * tq) * T::kLd + gq;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            uint32_t bh0, bl0, bh1, bl1;
            float t[4] = {0.f, 0.f, 0.f, 0.f};  // each step summed apart (add_frag)
            split_tf32(Gs[o + 8 * nt], bh0, bl0);
            split_tf32(Gs[o + T::kLd + 8 * nt], bh1, bl1);
            mma_split<kDkvTerms>(t, ph, pl, bh0, bh1, bl0, bl1);
            add_frag(dva[nt], t);
            t[0] = t[1] = t[2] = t[3] = 0.f;
            split_tf32(Qs[o + 8 * nt], bh0, bl0);
            split_tf32(Qs[o + T::kLd + 8 * nt], bh1, bl1);
            mma_split<kDkvTerms>(t, dh, dlo, bh0, bh1, bl0, bl1);
            add_frag(dka[nt], t);
          }
        }
      }
      tq_.push(nxt);
    }
    cp_async_wait<0>();
  }

  // ---- epilogue: rows of padded keys exactly 0 (no query attends them)
  const size_t o0 = (((size_t)b * Lk + r0) * H + h) * D + 2 * tq, o1 = (((size_t)b * Lk + r1) * H + h) * D + 2 * tq;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (in0) {
      *reinterpret_cast<float2*>(dk + o0 + 8 * nt) = kid0 >= 0 ? make_float2(dka[nt][0], dka[nt][1]) : make_float2(0.f, 0.f);
      *reinterpret_cast<float2*>(dv + o0 + 8 * nt) = kid0 >= 0 ? make_float2(dva[nt][0], dva[nt][1]) : make_float2(0.f, 0.f);
    }
    if (in1) {
      *reinterpret_cast<float2*>(dk + o1 + 8 * nt) = kid1 >= 0 ? make_float2(dka[nt][2], dka[nt][3]) : make_float2(0.f, 0.f);
      *reinterpret_cast<float2*>(dv + o1 + 8 * nt) = kid1 >= 0 ? make_float2(dva[nt][2], dva[nt][3]) : make_float2(0.f, 0.f);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 dq (K5, K8 on fp32 operands: PF training, SR training at "default"
// precision): dk/dv's design with the roles of the two axes swapped, its
// three products (S = Q K^T, dP = G V^T, dQ += dS K) on the tensor cores as
// three-term TF32 splits (tf32_attention.cuh), fp32-faithful, deterministic.
//
// What bounds it: at D = 16 (PF) the least time is the split products (3
// TF32 products for each of the 6*D flops a pair, ~11 us at (32, 640, 4,
// 16)); beside them each warp reads and splits every K value of a streamed
// tile twice, once in each of the two orders the products read it (as the B
// operand of S = Q K^T, and of dQ += dS K), every V value once, dS once, and
// runs the elementwise part (mask select, - lse, min, exp2, - dl, multiply)
// beside one exp2 a pair.  On the card the products' mma.sync rate holds it,
// as it does dk/dv (PERF.md §6: with single TF32 products, a third of the
// mma.sync, it takes 0.039 against 0.068 ms at (32, 640, 4, 16); S and dP
// take about half of a block's cycles, dQ a fifth).  The design: a block of
// 4 warps owns 64 query rows; their Q and G A fragments are stored once in
// shared memory in fragment order (dq_own_split), their lse and dl wait in
// registers; K and V tiles with their key ids stream through a two-stage
// cp.async ring (one barrier a tile) whose rows (D + 4 floats) make K's
// reads in both orders free of bank conflicts; dS goes from the accumulator
// into the A operand of dQ with no shuffle (K's rows read at 2t, 2t + 1,
// tf32_attention.cuh); each 8-key step of dQ is summed apart and added in
// fp32 (add_frag); at D = 64 a tile goes in two halves of 32 keys
// (registers); only key tiles with a key of the block's ids are visited.
// ---------------------------------------------------------------------------
constexpr int kDqTerms = 3;  // terms of each split product (1: single TF32)

// The block's own Q and G fragments: at D = 16 split once, hi and lo, into
// shared memory (four 16-byte reads a k-step, no split in the loop: ~5%
// faster); from D = 32 raw (two 16-byte reads and two splits a k-step: split,
// they took a block an SM at D = 64, +14%) (PERF.md §6).
template <int D> __host__ __device__ constexpr bool dq_own_split() { return D == 16; }
template <int D> using DqSmem = BwdF32<D, 1, dq_own_split<D>() ? 4 : 2>;


// q, k, v, g: (B, L, H, D) fp32 views with D contiguous; lse, dl (B, H, Lq);
// dq (B, Lq, H, D) contiguous; one block per (query tile of 64, head, batch
// row); dynamic shared memory DqSmem<D>::smem_bytes.
template <int D, bool SEG>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                        const float* __restrict__ g, const float* __restrict__ lse, const float* __restrict__ dl,
                        const void* __restrict__ qmask, const void* __restrict__ kmask, float* __restrict__ dq,
                        int H, int Lq, int Lk, Strides qs, Strides ks, Strides vs, Strides gs) {
  using T = DqSmem<D>;
  constexpr int KS = D / 8, NT = D / 8, NJ = kF32Tile / 8;  // k-steps over D, output n-tiles, key n-tiles
  // key steps a pass takes: at D = 64 a tile goes in two halves of 32 keys
  // (S and dP for 64 keys beside the dQ accumulators), as dk/dv's queries
  constexpr int NJS = D == 64 ? NJ / 2 : NJ;
  constexpr int NS = T::kStages;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* own = reinterpret_cast<uint4*>(smem);  // [Q, G] or [Q hi, Q lo, G hi, G lo]; [warp][k-step][lane]
  unsigned char* ring = smem + T::kOwnBytes;
  unsigned char* live = ring + NS * T::kStageBytes;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z, nkt = (Lk + kF32Tile - 1) / kF32Tile;
  const int r0 = blockIdx.x * kF32Rows + warp * 16 + gq, r1 = r0 + 8;  // this thread's query rows
  auto slot = [&](int a, int kk) { return ((4 * a + warp) * KS + kk) * 32 + lane; };  // this thread's, of array a
  const bool in0 = r0 < Lq, in1 = r1 < Lq;
  const size_t qrow = (size_t)b * Lq;
  const bool val0 = in0 && query_valid<SEG>(qmask, qrow + r0), val1 = in1 && query_valid<SEG>(qmask, qrow + r1);
  // the ids the rows compare the keys' with: segment ids, or with padding
  // masks 0 for every row
  const int qid0 = SEG ? (in0 ? query_id<SEG>(qmask, qrow + r0) : kPadSeg) : 0;
  const int qid1 = SEG ? (in1 ? query_id<SEG>(qmask, qrow + r1) : kPadSeg) : 0;
  // this thread's A fragments of Q and G (rows r0, r1; head-dim columns
  // 8kk + t, 8kk + t + 4), raw or split, into its own slots (before the
  // first barrier, so that the loads' latency overlaps it)
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const float* q0p = q + (size_t)b * qs.b + (size_t)(in0 ? r0 : 0) * qs.l + (size_t)h * qs.h + 8 * kk + tq;
    const float* q1p = q + (size_t)b * qs.b + (size_t)(in1 ? r1 : 0) * qs.l + (size_t)h * qs.h + 8 * kk + tq;
    const float* g0p = g + (size_t)b * gs.b + (size_t)(in0 ? r0 : 0) * gs.l + (size_t)h * gs.h + 8 * kk + tq;
    const float* g1p = g + (size_t)b * gs.b + (size_t)(in1 ? r1 : 0) * gs.l + (size_t)h * gs.h + 8 * kk + tq;
    const float4 qf = make_float4(in0 ? q0p[0] : 0.f, in1 ? q1p[0] : 0.f, in0 ? q0p[4] : 0.f, in1 ? q1p[4] : 0.f);
    const float4 gf = make_float4(in0 ? g0p[0] : 0.f, in1 ? g1p[0] : 0.f, in0 ? g0p[4] : 0.f, in1 ? g1p[4] : 0.f);
    if constexpr (dq_own_split<D>()) {
      uint32_t hi[4], lo[4];
      split_frag(qf.x, qf.y, qf.z, qf.w, hi, lo);
      own[slot(0, kk)] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      own[slot(1, kk)] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      split_frag(gf.x, gf.y, gf.z, gf.w, hi, lo);
      own[slot(2, kk)] = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      own[slot(3, kk)] = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    } else {
      own[slot(0, kk)] = make_uint4(__float_as_uint(qf.x), __float_as_uint(qf.y), __float_as_uint(qf.z),
                                    __float_as_uint(qf.w));
      own[slot(1, kk)] = make_uint4(__float_as_uint(gf.x), __float_as_uint(gf.y), __float_as_uint(gf.z),
                                    __float_as_uint(gf.w));
    }
  }
  // the split A fragments of Q and G at k-step kk
  auto own_frags = [&](int kk, uint32_t (&qh)[4], uint32_t (&ql)[4], uint32_t (&gh)[4], uint32_t (&gl)[4]) {
    if constexpr (dq_own_split<D>()) {
      const uint4 a = own[slot(0, kk)], c = own[slot(1, kk)], e = own[slot(2, kk)], f = own[slot(3, kk)];
      qh[0] = a.x, qh[1] = a.y, qh[2] = a.z, qh[3] = a.w;
      ql[0] = c.x, ql[1] = c.y, ql[2] = c.z, ql[3] = c.w;
      gh[0] = e.x, gh[1] = e.y, gh[2] = e.z, gh[3] = e.w;
      gl[0] = f.x, gl[1] = f.y, gl[2] = f.z, gl[3] = f.w;
    } else {
      const uint4 qa = own[slot(0, kk)], ga = own[slot(1, kk)];
      split_frag(__uint_as_float(qa.x), __uint_as_float(qa.y), __uint_as_float(qa.z), __uint_as_float(qa.w), qh, ql);
      split_frag(__uint_as_float(ga.x), __uint_as_float(ga.y), __uint_as_float(ga.z), __uint_as_float(ga.w), gh, gl);
    }
  };
  const size_t rb = ((size_t)b * H + h) * Lq;
  const float lse0 = in0 ? lse[rb + r0] : 0.f, lse1 = in1 ? lse[rb + r1] : 0.f;
  const float dl0 = in0 ? dl[rb + r0] : 0.f, dl1 = in1 ? dl[rb + r1] : 0.f;
  // padding masks: a key tile is live if it holds a valid key, whatever the queries
  if (!SEG) flag_live_tiles<SEG>(kmask, (size_t)b * Lk, Lk, make_int2(0, 0), live);
  const int2 ids = block_id_range(val0, qid0, val1, qid1);

  float dqa[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) dqa[nt][0] = dqa[nt][1] = dqa[nt][2] = dqa[nt][3] = 0.f;

  if (ids.x <= ids.y) {
    if (SEG) {  // segments: a key tile is live if it holds a key of the block's segments
      flag_live_tiles<SEG>(kmask, (size_t)b * Lk, Lk, ids, live);
      __syncthreads();
    }
    auto stage = [&](int s) { return ring + s * T::kStageBytes; };
    auto issue = [&](int s, int kt) {
      unsigned char* st = stage(s);
      tile_async<D, T::kLd>(reinterpret_cast<float*>(st), k, ks, b, h, kt * kF32Tile, Lk);
      tile_async<D, T::kLd>(reinterpret_cast<float*>(st + T::kTileBytes), v, vs, b, h, kt * kF32Tile, Lk);
      row_async(st + 2 * T::kTileBytes, static_cast<const unsigned char*>(kmask) + (size_t)b * Lk * 4,
                kt * kF32Tile, Lk);
    };
    TileQueue<NS> tq_;
#pragma unroll
    for (int s = 0; s < NS - 1; ++s) {
      tq_.pend[s] = tq_.advance(live, nkt);
      if (tq_.pend[s] < nkt) issue(s, tq_.pend[s]);
      cp_async_commit();
    }
    for (int i = 0; tq_.pend[0] < nkt; ++i) {
      const int cur = tq_.pend[0], s = i % NS;
      cp_async_wait<NS - 2>();  // this thread's copies of tile i have landed
      unsigned char* st = stage(s);
      const float* Ks = reinterpret_cast<const float*>(st);
      const float* Vs = reinterpret_cast<const float*>(st + T::kTileBytes);
      int* kid = reinterpret_cast<int*>(st + 2 * T::kTileBytes);
      ids_in_place<SEG, true>(kid, cur * kF32Tile, Lk);
      __syncthreads();
      // one barrier a tile: tile i is visible, and every warp is past tile
      // i - 1, whose stage takes the copy of tile i + NS - 1
      const int nxt = tq_.advance(live, nkt);
      if (nxt < nkt) issue((i + NS - 1) % NS, nxt);
      cp_async_commit();

#pragma unroll 1
      for (int sub = 0; sub < NJ / NJS; ++sub) {  // a loop: unrolled, ptxas hoisted the halves into each other and spilled
        const int j0 = sub * NJS;
        // ---- S = Q K^T and dP = G V^T: 16 queries x 8 NJS keys a warp
        // (c: query rows g, g+8; keys 8(j0 + j) + 2t, +1)
        float sc[NJS][4], dp[NJS][4];
#pragma unroll
        for (int j = 0; j < NJS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll  // unrolled at every head dim: unlike dk/dv's, no spill (PERF.md §6)
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t qh[4], ql[4], gh[4], gl[4];
          own_frags(kk, qh, ql, gh, gl);
#pragma unroll
          for (int j = 0; j < NJS; ++j) {
            const int o = (8 * (j0 + j) + gq) * T::kLd + 8 * kk + tq;
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(Ks[o], bh0, bl0);
            split_tf32(Ks[o + 4], bh1, bl1);
            mma_split<kDqTerms>(sc[j], qh, ql, bh0, bh1, bl0, bl1);
            split_tf32(Vs[o], bh0, bl0);
            split_tf32(Vs[o + 4], bh1, bl1);
            mma_split<kDqTerms>(dp[j], gh, gl, bh0, bh1, bl0, bl1);
          }
        }

        // ---- P = exp2(min(s - lse, 0)) on attended pairs, dS = P (dP - dl)
#pragma unroll
        for (int j = 0; j < NJS; ++j) {
          const int2 id = *reinterpret_cast<const int2*>(kid + 8 * (j0 + j) + 2 * tq);
          dp[j][0] = ex2(fminf((id.x == qid0 ? sc[j][0] : kNegInf) - lse0, 0.f)) * (dp[j][0] - dl0);
          dp[j][1] = ex2(fminf((id.y == qid0 ? sc[j][1] : kNegInf) - lse0, 0.f)) * (dp[j][1] - dl0);
          dp[j][2] = ex2(fminf((id.x == qid1 ? sc[j][2] : kNegInf) - lse1, 0.f)) * (dp[j][2] - dl1);
          dp[j][3] = ex2(fminf((id.y == qid1 ? sc[j][3] : kNegInf) - lse1, 0.f)) * (dp[j][3] - dl1);
        }

        // ---- dQ += dS K: dS's accumulator is the A operand (keys 8j + 2t,
        // +1), K's rows read in that order
#pragma unroll
        for (int j = 0; j < NJS; ++j) {
          uint32_t dh[4], dlo[4];
          split_frag(dp[j][0], dp[j][2], dp[j][1], dp[j][3], dh, dlo);
          const int o = (8 * (j0 + j) + 2 * tq) * T::kLd + gq;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            uint32_t bh0, bl0, bh1, bl1;
            float t[4] = {0.f, 0.f, 0.f, 0.f};  // each step summed apart (add_frag)
            split_tf32(Ks[o + 8 * nt], bh0, bl0);
            split_tf32(Ks[o + T::kLd + 8 * nt], bh1, bl1);
            mma_split<kDqTerms>(t, dh, dlo, bh0, bh1, bl0, bl1);
            add_frag(dqa[nt], t);
          }
        }
      }
      tq_.push(nxt);
    }
    cp_async_wait<0>();
  }

  // ---- epilogue: rows of padded queries exactly 0
  const size_t o0 = (((size_t)b * Lq + r0) * H + h) * D + 2 * tq, o1 = (((size_t)b * Lq + r1) * H + h) * D + 2 * tq;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (in0) *reinterpret_cast<float2*>(dq + o0 + 8 * nt) = val0 ? make_float2(dqa[nt][0], dqa[nt][1]) : make_float2(0.f, 0.f);
    if (in1) *reinterpret_cast<float2*>(dq + o1 + 8 * nt) = val1 ? make_float2(dqa[nt][2], dqa[nt][3]) : make_float2(0.f, 0.f);
  }
}

// ---------------------------------------------------------------------------
// launch: the bf16 kernels by tensor maps (block_rows 64 or 128: NC = 1 or
// 2), the fp32 kernels by strides
// ---------------------------------------------------------------------------
template <int D, bool SEG, int NC> static cudaError_t bwd_opt_in_smem() {
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<D, SEG, NC>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, BwdSmem<D, NC, false>::kBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_bwd_dkv_wgmma_kernel<D, SEG, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             BwdSmem<D, NC, true>::kBytes);
  if (e == cudaSuccess && NC == 1)
    e = cudaFuncSetAttribute(flash_bwd_dkv_f32_kernel<D, SEG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kF32MaxSmem);
  if (e == cudaSuccess && NC == 1)
    e = cudaFuncSetAttribute(flash_bwd_dq_f32_kernel<D, SEG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kF32MaxSmem);
  return e;
}

// Every bf16 instantiation's shared-memory opt-in, once per process, on the
// first call (which the wrappers make eagerly, never inside a graph capture).
static cudaError_t bwd_opt_in_all() {
  static cudaError_t done = cudaErrorNotReady;
  if (done == cudaErrorNotReady) {
    done = cudaSuccess;
#define SRHEP_BWD_OPT_IN(DD)                                           \
  if (done == cudaSuccess) done = bwd_opt_in_smem<DD, false, 1>();    \
  if (done == cudaSuccess) done = bwd_opt_in_smem<DD, false, 2>();    \
  if (done == cudaSuccess) done = bwd_opt_in_smem<DD, true, 1>();     \
  if (done == cudaSuccess) done = bwd_opt_in_smem<DD, true, 2>();
    SRHEP_BWD_OPT_IN(16)
    SRHEP_BWD_OPT_IN(32)
    SRHEP_BWD_OPT_IN(64)
#undef SRHEP_BWD_OPT_IN
  }
  return done;
}

// the operands' maps (q, g over Lq; k, v over Lk), and the contiguous
// (B, L, H, D) output's
template <int D>
static bool encode_bwd_maps(CUtensorMap (&m)[4], const void* q, const void* k, const void* v, const void* g, int B,
                            int H, int Lq, int Lk, Strides qs, Strides ks, Strides vs, Strides gs) {
  return encode_operand(&m[0], q, D, Lq, H, B, qs) && encode_operand(&m[1], k, D, Lk, H, B, ks) &&
         encode_operand(&m[2], v, D, Lk, H, B, vs) && encode_operand(&m[3], g, D, Lq, H, B, gs);
}
static bool encode_output(CUtensorMap* map, const void* out, int D, int L, int H, int B) {
  return encode_operand(map, out, D, L, H, B, Strides{(long long)L * H * D, (long long)H * D, D});
}

template <int D, bool SEG>
static int launch_dq(const void* q, const void* k, const void* v, const void* g, const void* lse, const void* dl,
                     const void* qmask, const void* kmask, const int* band, void* dq, int B, int H, int Lq, int Lk,
                     Strides qs, Strides ks, Strides vs, Strides gs, int is_bf16, int block_rows, int ldr,
                     cudaStream_t stream) {
  if (!is_bf16) {
    const cudaError_t opt = bwd_opt_in_all();
    if (opt != cudaSuccess) return (int)opt;
    const int smem = DqSmem<D>::smem_bytes((Lk + kF32Tile - 1) / kF32Tile);
    if (smem > kF32MaxSmem) return (int)cudaErrorInvalidValue;
    const dim3 grid((Lq + kF32Rows - 1) / kF32Rows, H, B);
    flash_bwd_dq_f32_kernel<D, SEG><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(g), static_cast<const float*>(lse), static_cast<const float*>(dl), qmask, kmask,
        static_cast<float*>(dq), H, Lq, Lk, qs, ks, vs, gs);
    return (int)cudaGetLastError();
  }
  const cudaError_t opt = bwd_opt_in_all();
  if (opt != cudaSuccess) return (int)opt;
  CUtensorMap m[4], tdq;
  if (!encode_bwd_maps<D>(m, q, k, v, g, B, H, Lq, Lk, qs, ks, vs, gs) || !encode_output(&tdq, dq, D, Lq, H, B))
    return (int)cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  const float* d = static_cast<const float*>(dl);
  bf16* o = static_cast<bf16*>(dq);
  if (block_rows == 128)
    flash_bwd_dq_wgmma_kernel<D, SEG, 2><<<dim3((Lq + 127) / 128, H, B), 288, BwdSmem<D, 2, false>::kBytes, stream>>>(
        m[0], m[1], m[2], m[3], tdq, l, d, qmask, kmask, band, o, H, Lq, Lk, ldr);
  else if (block_rows == 64)
    flash_bwd_dq_wgmma_kernel<D, SEG, 1><<<dim3((Lq + 63) / 64, H, B), 160, BwdSmem<D, 1, false>::kBytes, stream>>>(
        m[0], m[1], m[2], m[3], tdq, l, d, qmask, kmask, band, o, H, Lq, Lk, ldr);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

template <int D, bool SEG>
static int launch_dkv(const void* q, const void* k, const void* v, const void* g, const void* lse, const void* dl,
                      const void* qmask, const void* kmask, const int* band, void* dk, void* dv, int B, int H, int Lq,
                      int Lk, Strides qs, Strides ks, Strides vs, Strides gs, int is_bf16, int block_rows, int ldr,
                      cudaStream_t stream) {
  if (!is_bf16) {
    const cudaError_t opt = bwd_opt_in_all();
    if (opt != cudaSuccess) return (int)opt;
    const int smem = BwdF32<D, 3, 2>::smem_bytes((Lq + kF32Tile - 1) / kF32Tile);
    if (smem > kF32MaxSmem) return (int)cudaErrorInvalidValue;
    const dim3 grid((Lk + kF32Rows - 1) / kF32Rows, H, B);
    flash_bwd_dkv_f32_kernel<D, SEG><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(g), static_cast<const float*>(lse), static_cast<const float*>(dl), qmask, kmask,
        static_cast<float*>(dk), static_cast<float*>(dv), H, Lq, Lk, qs, ks, vs, gs);
    return (int)cudaGetLastError();
  }
  const cudaError_t opt = bwd_opt_in_all();
  if (opt != cudaSuccess) return (int)opt;
  CUtensorMap m[4], tlse, tdl, tdk, tdv, tids;
  if (!encode_bwd_maps<D>(m, q, k, v, g, B, H, Lq, Lk, qs, ks, vs, gs) ||
      !encode_rows_32(&tlse, lse, Lq, B * H, ldr, false) || !encode_rows_32(&tdl, dl, Lq, B * H, ldr, false) ||
      !encode_output(&tdk, dk, D, Lk, H, B) || !encode_output(&tdv, dv, D, Lk, H, B))
    return (int)cudaErrorInvalidValue;
  if (SEG ? !encode_rows_32(&tids, qmask, Lq, B, Lq, true) : !encode_rows_32(&tids, lse, Lq, B * H, ldr, false))
    return (int)cudaErrorInvalidValue;  // padding masks read no ids: any valid map
  bf16* ok = static_cast<bf16*>(dk);
  bf16* ov = static_cast<bf16*>(dv);
  if (block_rows == 128)
    flash_bwd_dkv_wgmma_kernel<D, SEG, 2><<<dim3((Lk + 127) / 128, H, B), 256, BwdSmem<D, 2, true>::kBytes, stream>>>(
        m[0], m[1], m[2], m[3], tlse, tdl, tdk, tdv, tids, qmask, kmask, band, ok, ov, H, Lq, Lk);
  else if (block_rows == 64)
    flash_bwd_dkv_wgmma_kernel<D, SEG, 1><<<dim3((Lk + 63) / 64, H, B), 128, BwdSmem<D, 1, true>::kBytes, stream>>>(
        m[0], m[1], m[2], m[3], tlse, tdl, tdk, tdv, tids, qmask, kmask, band, ok, ov, H, Lq, Lk);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace srhep

// q (B, Lq, H, D), k, v (B, Lk, H, D), g (B, Lq, H, D) as strided views with D
// contiguous (strides in elements, 16-byte aligned); lse, dl (B, H, Lq) fp32
// with row stride ldr (bf16: a multiple of 4, >= Lq; fp32: Lq); qm (B, Lq),
// km (B, Lk) fp32; dq (B, Lq, H, D) contiguous, in q's dtype, WITHOUT the
// ln(2) factor.  D in {16, 32, 64}; block_rows (bf16): query rows per block,
// 64 or 128.  Returns cudaGetLastError().
extern "C" int srhep_flash_bwd_dq(const void* q, const void* k, const void* v, const void* g, const void* lse,
                                  const void* dl, const void* qm, const void* km, void* dq, int B, int H, int Lq,
                                  int Lk, int D, long long qsb, long long qsl, long long qsh, long long ksb,
                                  long long ksl, long long ksh, long long vsb, long long vsl, long long vsh,
                                  long long gsb, long long gsl, long long gsh, int is_bf16, int block_rows, int ldr,
                                  void* stream) {
  using namespace srhep;
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  if (!is_bf16 && ldr != Lq) return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qsl, qsh}, ks{ksb, ksl, ksh}, vs{vsb, vsl, vsh}, gs{gsb, gsl, gsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SRHEP_BWD_CASE(DD)                                                                                        \
  case DD:                                                                                                        \
    return launch_dq<DD, false>(q, k, v, g, lse, dl, qm, km, nullptr, dq, B, H, Lq, Lk, qs, ks, vs, gs, is_bf16, \
                                block_rows, ldr, s);
  switch (D) {
    SRHEP_BWD_CASE(16)
    SRHEP_BWD_CASE(32)
    SRHEP_BWD_CASE(64)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SRHEP_BWD_CASE
}

// Same operands; dk, dv (B, Lk, H, D) contiguous in k's / v's dtype, dk
// WITHOUT the ln(2) factor; block_rows (bf16): key rows per block.
extern "C" int srhep_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* g, const void* lse,
                                   const void* dl, const void* qm, const void* km, void* dk, void* dv, int B, int H,
                                   int Lq, int Lk, int D, long long qsb, long long qsl, long long qsh, long long ksb,
                                   long long ksl, long long ksh, long long vsb, long long vsl, long long vsh,
                                   long long gsb, long long gsl, long long gsh, int is_bf16, int block_rows, int ldr,
                                   void* stream) {
  using namespace srhep;
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  if (!is_bf16 && ldr != Lq) return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qsl, qsh}, ks{ksb, ksl, ksh}, vs{vsb, vsl, vsh}, gs{gsb, gsl, gsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SRHEP_BWD_CASE(DD)                                                                                     \
  case DD:                                                                                                     \
    return launch_dkv<DD, false>(q, k, v, g, lse, dl, qm, km, nullptr, dk, dv, B, H, Lq, Lk, qs, ks, vs, gs, \
                                 is_bf16, block_rows, ldr, s);
  switch (D) {
    SRHEP_BWD_CASE(16)
    SRHEP_BWD_CASE(32)
    SRHEP_BWD_CASE(64)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SRHEP_BWD_CASE
}

// Segment-packed rows (K8): q, k, v, g (B, S, H, D) as strided views with D
// contiguous, g zeroed on padding; lse, dl (B, H, S) fp32 with row stride ldr;
// seg (B, S) int32, -1 on padding, valid ids nondecreasing along each row;
// band (bf16 only): the srhep_packed_band table at block_rows x 64 tiles; dq
// (B, S, H, D) contiguous, WITHOUT the ln(2) factor.  D in {16, 32, 64}.
extern "C" int srhep_packed_bwd_dq(const void* q, const void* k, const void* v, const void* g, const void* lse,
                                   const void* dl, const void* seg, const void* band, void* dq, int B, int H, int S,
                                   int D, long long qsb, long long qsl, long long qsh, long long ksb, long long ksl,
                                   long long ksh, long long vsb, long long vsl, long long vsh, long long gsb,
                                   long long gsl, long long gsh, int is_bf16, int block_rows, int ldr, void* stream) {
  using namespace srhep;
  if (B <= 0 || H <= 0 || S <= 0 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  if ((!is_bf16 && ldr != S) || (is_bf16 && band == nullptr)) return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qsl, qsh}, ks{ksb, ksl, ksh}, vs{vsb, vsl, vsh}, gs{gsb, gsl, gsh};
  const int* bd = static_cast<const int*>(band);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SRHEP_BWD_CASE(DD)                                                                                           \
  case DD:                                                                                                           \
    return launch_dq<DD, true>(q, k, v, g, lse, dl, seg, seg, bd, dq, B, H, S, S, qs, ks, vs, gs, is_bf16, block_rows, \
                               ldr, st);
  switch (D) {
    SRHEP_BWD_CASE(16)
    SRHEP_BWD_CASE(32)
    SRHEP_BWD_CASE(64)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SRHEP_BWD_CASE
}

// Segment-packed rows (K9): the same operands; dk, dv (B, S, H, D) contiguous,
// dk WITHOUT the ln(2) factor.
extern "C" int srhep_packed_bwd_dkv(const void* q, const void* k, const void* v, const void* g, const void* lse,
                                    const void* dl, const void* seg, const void* band, void* dk, void* dv, int B,
                                    int H, int S, int D, long long qsb, long long qsl, long long qsh, long long ksb,
                                    long long ksl, long long ksh, long long vsb, long long vsl, long long vsh,
                                    long long gsb, long long gsl, long long gsh, int is_bf16, int block_rows, int ldr,
                                    void* stream) {
  using namespace srhep;
  if (B <= 0 || H <= 0 || S <= 0 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  if ((!is_bf16 && ldr != S) || (is_bf16 && band == nullptr)) return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qsl, qsh}, ks{ksb, ksl, ksh}, vs{vsb, vsl, vsh}, gs{gsb, gsl, gsh};
  const int* bd = static_cast<const int*>(band);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SRHEP_BWD_CASE(DD)                                                                                        \
  case DD:                                                                                                        \
    return launch_dkv<DD, true>(q, k, v, g, lse, dl, seg, seg, bd, dk, dv, B, H, S, S, qs, ks, vs, gs, is_bf16, \
                                block_rows, ldr, st);
  switch (D) {
    SRHEP_BWD_CASE(16)
    SRHEP_BWD_CASE(32)
    SRHEP_BWD_CASE(64)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SRHEP_BWD_CASE
}
