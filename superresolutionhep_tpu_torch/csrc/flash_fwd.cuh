// The bf16 attention forward body for Hopper (sm_90a): one source for every
// kernel of the port that computes an attention forward on TMA + wgmma,
//   * flash_attention.cu: the shipped kernels K1, K2 (padding masks) and K7
//     (segment-packed rows), flash_fwd_wgmma_kernel;
//   * attention_probes.cu: the measuring scripts' probes K10 and K11,
//     probe_fwd_wgmma_kernel,
// so that the probes time the body that ships.  Each kernel is a thin
// __global__ around fwd_wgmma_body<D, NC, Soft>, where the policy type Soft
// holds what its users compute differently (the softmax, the key words the
// producer carries, which tiles it skips, the output layout; list below).
//
// The design (the bound: operations and, beside them, the exponentials; see
// flash_attention.cu):
//   * warp specialisation: one producer warp keeps TMA loads of K/V tiles in
//     flight through a ring of mbarrier full/empty pairs (5 stages, 3 where
//     two blocks share an SM); NC consumer warpgroups of 64 query rows each
//     run the products: NC = 3 (a K/V tile serves 192 queries) for large
//     grids, NC = 1 (two blocks per SM) for small ones; setmaxnreg moves
//     registers from the producer to the consumers.  128-row blocks (NC = 2)
//     were never the fastest of the three on the H100 (PERF.md) and are not
//     built;
//   * S = Q K^T as wgmma.m64nBKk16 from shared memory (Q and K K-major, TMA
//     swizzle = the row's 32/64/128 bytes for D = 16/32/64, the same layout
//     in the wgmma descriptors); O += P V with P in registers (the S
//     accumulator repacked to bf16 pairs) and V read MN-major from its
//     [key][d] tile.  Key tiles of 64 (kBK) in the shipped kernels: 128
//     measured no faster and spilled;
//   * the exponentials under the products (Soft::kOverlap): each consumer
//     issues S_{j+1} before P_j V_j and runs the softmax of tile j+1 while
//     P_j V_j is on the tensor cores.  S_{j+1}, P_j and O then live together:
//     32 + 16 + 32 registers a thread at 64 keys, but 64 + 32 + 32 at 128,
//     all of the 128 a thread that both launch bounds give, so 128-key tiles
//     (the probes') run one tile at a time: S, its softmax, P V;
//   * the consumer warpgroups take turns to issue (named barriers), so that
//     one's softmax overlaps another's products;
//   * the producer reads each key's 32-bit word (Soft::key: the key mask or
//     segment id, or the probes' additive bias) four 64-key tiles ahead,
//     skips dead tiles itself where Soft::kSkipDead, and writes the words and
//     the tile's index into the stage, so consumers follow its sequence and
//     never disagree with it; a stage with index -1 ends the sequence.
#pragma once

#include "common.cuh"

namespace srhep {

// ---------------------------------------------------------------------------
// Block = NC consumer warpgroups (64 query rows each) + one producer
// warpgroup; key tiles of BK.  In a consumer warpgroup, lane = 4*g + t of warp
// w holds rows 16w + g and 16w + g + 8 of the warpgroup's 64, columns 8j + 2t,
// 8j + 2t + 1 of every 8-wide slice (accumulator element 4j + e: e & 2 picks
// the row, e & 1 the column).
// ---------------------------------------------------------------------------
constexpr int kBK = 64;        // keys per tile of the shipped kernels: one TMA box, the N of the S product (m64n64k16)
constexpr int kLookahead = 4;  // 64-key tiles whose key words the producer has in flight
constexpr int kTmaRows = 64;   // rows per TMA box (Q, K and V)

// K/V ring depth: 5 stages with one block per SM, 3 where two blocks share one
template <int NC> __host__ __device__ constexpr int fwd_stages() { return NC == 1 ? 3 : 5; }

template <int NC> struct FwdRegs;  // setmaxnreg budgets: producer + NC * consumer = (NC + 1) * launch bound
template <> struct FwdRegs<1> { static constexpr int kProducer = 24, kConsumer = 232, kMinBlocks = 2; };
template <> struct FwdRegs<3> { static constexpr int kProducer = 32, kConsumer = 160, kMinBlocks = 1; };

// bytes of dynamic shared memory: 1024 of alignment slack, Q, the K/V ring,
// the ring's key words and tile indices, the barriers
template <int D, int NC, int BK = kBK> constexpr int fwd_smem_bytes() {
  return 1024 + (NC + 2 * fwd_stages<NC>() * (BK / kTmaRows)) * FwdTiles<D>::kTileBytes + fwd_stages<NC>() * BK * 4 +
         32 + (2 * fwd_stages<NC>() + 1) * 8;
}

// Shared-memory descriptors of every wgmma of one step, computed and pinned
// before the step's wgmma.fence, so that no register a wgmma reads is defined
// between its fence and its wait (ptxas then serialises every wgmma).
template <int D, int BK> struct StepDescs {
  uint64_t q[D / 16], k[D / 16], v[BK / 16];
};
template <int D, int BK> __device__ __forceinline__ void make_qk_descs(StepDescs<D, BK>& d, uint32_t qs, uint32_t ks) {
  constexpr int SBO = 8 * FwdTiles<D>::kRowBytes, SW = FwdTiles<D>::kSwizzle;
#pragma unroll
  for (int st = 0; st < D / 16; ++st) {  // K-major: the next 16-deep k-step is 32 bytes further
    d.q[st] = gmma_desc(qs + 32 * st, SBO, SW);
    d.k[st] = gmma_desc(ks + 32 * st, SBO, SW);
    asm volatile("" : "+l"(d.q[st]), "+l"(d.k[st]));
  }
}
template <int D, int BK> __device__ __forceinline__ void make_v_descs(StepDescs<D, BK>& d, uint32_t vs) {
  constexpr int SBO = 8 * FwdTiles<D>::kRowBytes, SW = FwdTiles<D>::kSwizzle;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {  // MN-major V: the next 16 keys are 16 rows further
    d.v[kk] = gmma_desc(vs + 16 * kk * FwdTiles<D>::kRowBytes, SBO, SW);
    asm volatile("" : "+l"(d.v[kk]));
  }
}
template <int D, int BK>
__device__ __forceinline__ void make_descs(StepDescs<D, BK>& d, uint32_t qs, uint32_t ks, uint32_t vs) {
  make_qk_descs(d, qs, ks);
  make_v_descs(d, vs);
}

// S = Q K^T for one warpgroup: (64 x D) x (BK x D)^T, issued, not waited for
// (a 128-key tile is two TMA boxes back to back: one K-major operand of 128
// rows).  FRESH: the first k-step does not read S's old values, so S holds no
// registers between its last use and this product (128 keys only).
template <int D, int BK, bool FRESH = false>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2], const StepDescs<D, BK>& d) {
  static_assert(!FRESH || BK == 128, "a fresh S product is built for 128-key tiles");
#pragma unroll
  for (int st = 0; st < D / 16; ++st) {
    if constexpr (BK == 64) wgmma_ss_m64n64k16(s, d.q[st], d.k[st], st);
    else if (FRESH && st == 0) wgmma_ss_m64n128k16_fresh(s, d.q[st], d.k[st]);
    else wgmma_ss_m64n128k16(s, d.q[st], d.k[st], st);
  }
}

// O += P V for one warpgroup: P (64 x BK) from registers, V (BK x D) [key][d]
template <int D, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&p)[BK / 4], const StepDescs<D, BK>& d) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
    pv_mma<D>(o, a, d.v[kk]);
  }
}

// O (and, with ROWSUM, the row sums' accumulator) *= al per row, only where
// a row's max moved (al = 1 exactly elsewhere)
template <bool RESCALE, bool ROWSUM, int N>
__device__ __forceinline__ void rescale_o(float (&o)[N], float (&lsum)[4], float al0, float al1) {
  if (RESCALE && !__all_sync(0xffffffffu, al0 == 1.f && al1 == 1.f)) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      o[i] *= al0;
      o[i + 1] *= al0;
      o[i + 2] *= al1;
      o[i + 3] *= al1;
    }
    if (ROWSUM) {
      lsum[0] *= al0;
      lsum[1] *= al0;
      lsum[2] *= al1;
      lsum[3] *= al1;
    }
  }
}

// l += P 1 for one warpgroup on the tensor cores: P (64 x BK) from registers
// times a (BK x 8) tile of ones; every column of the 64 x 8 result is the row
// sum of P's bf16 values, accumulated in fp32
template <int BK>
__device__ __forceinline__ void issue_rowsum(float (&lsum)[4], const uint32_t (&p)[BK / 4], uint64_t ones) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
    wgmma_rs_m64n8k16(lsum, a, ones);
  }
}

// The body.  q, k, v: tensor maps over (D, L, H, B) with box (D, 64, 1, 1)
// (kernel parameters: __grid_constant__); band (Soft::kSeg): (B, gridDim.x, 2)
// int32 = (first key tile, count) per query tile; out: rows of D at
// Soft::out_row; lse (B, H, Lq) or null.  Soft provides
//   kBK        keys per K/V tile: 64, or 128 (two TMA boxes a tile);
//   kSeg       the key tiles of a query tile come from band;
//   kSkipDead  the producer skips a tile whose key words are all negative;
//   kOverlap   S_{j+1} is issued before P_j V_j (else one tile at a time);
//   kRescale   the softmax can move a row's running max (O is rescaled where it did);
//   kLse       the epilogue writes the base-2 log-sum-exp;
//   kRowSum    l is summed by the tensor cores beside P V (issue_rowsum: the
//              sum of P's bf16 values), not by tile();
//   key(kmask, i)                  the 32-bit word of key i the stage carries;
//   query_valid(qmask, i), query_id(qmask, i);
//   tile(s, words, t, qid0, qid1, m0, m1, l0, l1, al0, al1)
//                                  the softmax of one S tile in place: l, m
//                                  updated, al = O's rescale factor per row;
//   pack(s, p)                     the P fragments of P V from what tile left
//                                  in s, run once P V of the tile before is
//                                  done: P's registers are defined only then
//                                  (a register a wgmma in flight reads, defined
//                                  under it, makes ptxas serialise every wgmma).
//   out_row(b, h, r, H, Lq)        the row of out that query row r writes.
template <int D, int NC, class Soft>
__device__ __forceinline__ void fwd_wgmma_body(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                                               const void* __restrict__ qmask, const void* __restrict__ kmask,
                                               const int* __restrict__ band, bf16* __restrict__ out,
                                               float* __restrict__ lse, int H, int Lq, int Lk) {
  using T = FwdTiles<D>;
  constexpr int BK = Soft::kBK, KB = BK / kTmaRows;  // KB: TMA boxes per K or V tile
  constexpr int BQ = 64 * NC, NS = fwd_stages<NC>();
  static_assert(BK % kTmaRows == 0, "a K or V tile is whole TMA boxes");
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment: the period of the 128-byte swizzle, which TMA and wgmma both apply by address
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* Qs = reinterpret_cast<bf16*>(base);
  bf16* Ks = Qs + NC * 64 * D;
  bf16* Vs = Ks + NS * BK * D;  // stage s: K at Ks + s * BK * D, V at Vs + s * BK * D
  int* ids = reinterpret_cast<int*>(Vs + NS * BK * D);  // [NS][BK] key words
  int* tile = ids + NS * BK;                            // [NS], padded to 8
  uint64_t* full = reinterpret_cast<uint64_t*>(tile + 8);
  uint64_t* empty = full + NS;
  uint64_t* qfull = empty + NS;

  const int tid = threadIdx.x;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z, q0 = qt * BQ;

  bool row_valid = false;
  if (tid < BQ) row_valid = q0 + tid < Lq && Soft::query_valid(qmask, (size_t)b * Lq + q0 + tid);
  uint64_t ones_desc = 0;  // the B operand of issue_rowsum: 512 bytes of bf16 ones, read in any layout
  if constexpr (Soft::kRowSum) {
    __shared__ __align__(128) uint32_t ones[128];
    if (tid < 128) ones[tid] = 0x3F803F80u;
    fence_proxy_async();  // written by the threads, read by wgmma; the barrier below orders both
    ones_desc = gmma_desc(smem_u32(ones), 128, 0);
  }
  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(&full[s], 32);           // the producer warp's lanes (lane 0 also brings the TMA bytes)
      mbar_init(&empty[s], 128 * NC);    // every consumer thread
    }
    mbar_init(qfull, 1);
    fence_mbar_init();
  }
  if (!__syncthreads_or(row_valid)) {  // block-uniform: nothing to attend from; no barrier is ever waited on
    constexpr int V16 = D / 8;         // 16-byte pieces per row
    for (int c = tid; c < BQ * V16; c += blockDim.x) {
      const int r = q0 + c / V16;
      if (r < Lq) *reinterpret_cast<uint4*>(out + Soft::out_row(b, h, r, H, Lq) * D + 8 * (c % V16)) = make_uint4(0u, 0u, 0u, 0u);
    }
    if (lse != nullptr && tid < BQ && q0 + tid < Lq) lse[((size_t)b * H + h) * Lq + q0 + tid] = kNegInf;
    return;
  }

  // warp-uniform as far as the compiler can see, so that the wgmma descriptors
  // derived from it live in uniform registers
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == NC) {
    // ======================= producer warpgroup =======================
    warpgroup_reg_dealloc<FwdRegs<NC>::kProducer>();
    if (tid % 128 < 32) {
      const int lane = tid & 31;
      int kt_first = 0, kt_last = (Lk + BK - 1) / BK - 1;
      if (Soft::kSeg) {
        const int2 bd = *reinterpret_cast<const int2*>(band + 2 * ((size_t)b * gridDim.x + qt));
        kt_first = bd.x;
        kt_last = bd.x + bd.y - 1;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(qfull, NC * T::kTileBytes);
#pragma unroll
        for (int w = 0; w < NC; ++w) tma_load_4d(Qs + w * 64 * D, &tq, qfull, 0, q0 + 64 * w, h, b);
      }
      auto key = [&](int kpos) { return kpos < Lk ? Soft::key(kmask, (size_t)b * Lk + kpos) : kNoKey; };
      // the words of the next LA tiles are in flight in registers: a tile's
      // words are needed (for the skip and the stage) only LA tiles after
      // their load was issued, so the loads' latency does not chain from tile
      // to tile
      constexpr int IPL = BK / 32;                    // words per lane per tile
      constexpr int LA = (kLookahead * kTmaRows + BK - 1) / BK;  // the same words in flight a lane at 64 and 128 keys
      int qa[LA][IPL];
#pragma unroll
      for (int i = 0; i < LA; ++i)
#pragma unroll
        for (int c = 0; c < IPL; ++c) qa[i][c] = kt_first + i <= kt_last ? key((kt_first + i) * BK + 32 * c + lane) : kNoKey;
      int stage = 0;
      unsigned phase = 0;
      for (int kt = kt_first; kt <= kt_last; ++kt) {
        int id[IPL];
        bool live = false;
#pragma unroll
        for (int c = 0; c < IPL; ++c) {
          id[c] = qa[0][c];
          live = live || id[c] >= 0;
        }
#pragma unroll
        for (int i = 0; i + 1 < LA; ++i)
#pragma unroll
          for (int c = 0; c < IPL; ++c) qa[i][c] = qa[i + 1][c];
        const int nk = kt + LA;
#pragma unroll
        for (int c = 0; c < IPL; ++c) qa[LA - 1][c] = nk <= kt_last ? key(nk * BK + 32 * c + lane) : kNoKey;
        if (Soft::kSkipDead && !__any_sync(0xffffffffu, live)) continue;  // no live key in this tile
        mbar_wait(&empty[stage], phase ^ 1);
#pragma unroll
        for (int c = 0; c < IPL; ++c) ids[stage * BK + 32 * c + lane] = id[c];
        if (lane == 0) {
          tile[stage] = kt;
          mbar_arrive_expect_tx(&full[stage], 2 * KB * T::kTileBytes);
#pragma unroll
          for (int i = 0; i < KB; ++i) {
            tma_load_4d(Ks + (stage * BK + i * kTmaRows) * D, &tk, &full[stage], 0, kt * BK + i * kTmaRows, h, b);
            tma_load_4d(Vs + (stage * BK + i * kTmaRows) * D, &tv, &full[stage], 0, kt * BK + i * kTmaRows, h, b);
          }
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
  } else {
    // ======================= consumer warpgroups =======================
    warpgroup_reg_alloc<FwdRegs<NC>::kConsumer>();
    const int warp = (tid % 128) >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
    const int r0 = q0 + 64 * wg + 16 * warp + g, r1 = r0 + 8;
    const bool val0 = r0 < Lq && Soft::query_valid(qmask, (size_t)b * Lq + r0);
    const bool val1 = r1 < Lq && Soft::query_valid(qmask, (size_t)b * Lq + r1);
    const int qid0 = r0 < Lq ? Soft::query_id(qmask, (size_t)b * Lq + r0) : kPadSeg;
    const int qid1 = r1 < Lq ? Soft::query_id(qmask, (size_t)b * Lq + r1) : kPadSeg;

    float o[D / 2], s[BK / 2], lsum[4] = {0.f, 0.f, 0.f, 0.f};
    uint32_t p[BK / 4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf;  // running max of rows r0, r1 (where the softmax keeps one)
    float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sums
    float al0, al1;
    const uint32_t qs = smem_u32(Qs + wg * 64 * D), ks0 = smem_u32(Ks), vs0 = smem_u32(Vs);

    // Turns of the consumer warpgroups: each issues its products in turn
    // (named barrier 1 + w: "warpgroup w may issue", passed on by the
    // previous one after its own issue), so that one warpgroup's softmax runs
    // while another's products hold the tensor cores, instead of all
    // contending for the tensor cores and then all for the exponential units.
    // Every warpgroup has the same number of turns (the producer's
    // sequence), and warpgroup 0 takes one more at the end to match the
    // first pass that warpgroup NC - 1 gives it.
    constexpr bool kPingPong = NC > 1;
    auto my_turn = [&]() {
      if (kPingPong) named_bar_sync(1 + wg, 256);
    };
    auto pass_turn = [&]() {
      if (kPingPong) named_bar_arrive(1 + (wg + 1 == NC ? 0 : wg + 1), 256);
    };
    if (kPingPong && wg == NC - 1) named_bar_arrive(1, 256);

    mbar_wait(qfull, 0);
    int stage = 0;
    unsigned phase = 0;
    mbar_wait(&full[0], 0);
    if (tile[0] >= 0) {
      StepDescs<D, BK> dsc;
      if constexpr (Soft::kOverlap) {
        // S of the first tile and its softmax
        make_descs<D, BK>(dsc, qs, ks0, vs0);
        my_turn();
        wgmma_fence();
        issue_qk<D, BK>(s, dsc);
        wgmma_commit();
        pass_turn();
        wgmma_wait<0>();
        fence_operand(s);
        Soft::tile(s, ids, t, qid0, qid1, m0, m1, l0, l1, al0, al1);
        Soft::pack(s, p);
        // every further tile: S_{j+1} issued before P_j V_j, the softmax of
        // j+1 while P_j V_j runs.  The loop body holds no branch between an
        // issue and its wait, so that ptxas can keep the products in flight.
        while (true) {
          const int ns = stage + 1 == NS ? 0 : stage + 1;
          const unsigned nph = ns == 0 ? phase ^ 1 : phase;
          mbar_wait(&full[ns], nph);
          if (tile[ns] < 0) break;
          StepDescs<D, BK> dq;  // K of the next tile, V of this one
          make_descs<D, BK>(dq, qs, ks0 + ns * BK * T::kRowBytes, vs0 + stage * BK * T::kRowBytes);
          fence_operand(s);
          fence_operand(o);
          fence_operand(p);
          if constexpr (Soft::kRowSum) fence_operand(lsum);
          my_turn();
          wgmma_fence();
          issue_qk<D, BK>(s, dq);
          wgmma_commit();
          issue_pv<D, BK>(o, p, dq);
          if constexpr (Soft::kRowSum) issue_rowsum<BK>(lsum, p, ones_desc);
          wgmma_commit();
          pass_turn();
          wgmma_wait<1>();
          fence_operand(s);
          Soft::tile(s, ids + ns * BK, t, qid0, qid1, m0, m1, l0, l1, al0, al1);
          wgmma_wait<0>();
          fence_operand(o);
          fence_operand(p);
          if constexpr (Soft::kRowSum) fence_operand(lsum);
          rescale_o<Soft::kRescale, Soft::kRowSum>(o, lsum, al0, al1);
          mbar_arrive(&empty[stage]);
          Soft::pack(s, p);
          stage = ns;
          phase = nph;
        }
        // the last tile's P V
        make_descs<D, BK>(dsc, qs, ks0, vs0 + stage * BK * T::kRowBytes);
        fence_operand(o);
        fence_operand(p);
        if constexpr (Soft::kRowSum) fence_operand(lsum);
        my_turn();
        wgmma_fence();
        issue_pv<D, BK>(o, p, dsc);
        if constexpr (Soft::kRowSum) issue_rowsum<BK>(lsum, p, ones_desc);
        wgmma_commit();
        pass_turn();
        wgmma_wait<0>();
        fence_operand(o);
        if constexpr (Soft::kRowSum) fence_operand(lsum);
      } else {
        // one tile at a time: S (not reading its last values), its softmax,
        // P V; the descriptors of each product made just before it, so that
        // none is held across the softmax
        while (true) {
          make_qk_descs(dsc, qs, ks0 + stage * BK * T::kRowBytes);
          my_turn();
          wgmma_fence();
          issue_qk<D, BK, true>(s, dsc);
          wgmma_commit();
          pass_turn();
          wgmma_wait<0>();
          fence_operand(s);
          Soft::tile(s, ids + stage * BK, t, qid0, qid1, m0, m1, l0, l1, al0, al1);
          rescale_o<Soft::kRescale, Soft::kRowSum>(o, lsum, al0, al1);
          Soft::pack(s, p);
          make_v_descs(dsc, vs0 + stage * BK * T::kRowBytes);
          fence_operand(o);
          fence_operand(p);
          if constexpr (Soft::kRowSum) fence_operand(lsum);
          my_turn();
          wgmma_fence();
          issue_pv<D, BK>(o, p, dsc);
          if constexpr (Soft::kRowSum) issue_rowsum<BK>(lsum, p, ones_desc);
          wgmma_commit();
          pass_turn();
          wgmma_wait<0>();
          fence_operand(o);
          if constexpr (Soft::kRowSum) fence_operand(lsum);
          mbar_arrive(&empty[stage]);
          if (++stage == NS) {
            stage = 0;
            phase ^= 1;
          }
          mbar_wait(&full[stage], phase);
          if (tile[stage] < 0) break;
        }
      }
    }
    if (kPingPong && wg == 0) named_bar_sync(1, 256);

    if constexpr (Soft::kRowSum) {  // every column of the tensor cores' sums holds its row's whole sum
      l0 = lsum[0];
      l1 = lsum[2];
    } else {  // row sums across the 4 threads that share a row
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    }
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    const float f0 = val0 ? 1.f : 0.f, f1 = val1 ? 1.f : 0.f;
    bf16* o0p = out + Soft::out_row(b, h, r0, H, Lq) * D;
    bf16* o1p = out + Soft::out_row(b, h, r1, H, Lq) * D;
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd) {
      if (r0 < Lq)
        *reinterpret_cast<__nv_bfloat162*>(o0p + 8 * jd + 2 * t) =
            __floats2bfloat162_rn(o[4 * jd] / d0 * f0, o[4 * jd + 1] / d0 * f0);
      if (r1 < Lq)
        *reinterpret_cast<__nv_bfloat162*>(o1p + 8 * jd + 2 * t) =
            __floats2bfloat162_rn(o[4 * jd + 2] / d1 * f1, o[4 * jd + 3] / d1 * f1);
    }
    if (Soft::kLse && lse != nullptr && t == 0) {
      if (r0 < Lq) lse[((size_t)b * H + h) * Lq + r0] = m0 + log2f(d0);
      if (r1 < Lq) lse[((size_t)b * H + h) * Lq + r1] = m1 + log2f(d1);
    }
  }
}

}  // namespace srhep
