// Flash attention forward for Hopper (sm_90a): the robust running-max kernel
// and the inference-only no-max kernel (template flag NOMAX), each for
// padding masks and for segment-packed rows (template flag SEG, see
// common.cuh), from one source.
//
// Replaces the TPU kernels superresolutionhep_tpu/ops/flash_attention.py::
// _fwd_kernel (through _flash_fwd) and ::_fwd_kernel_nomax (through
// _flash_fwd_nomax) with SEG = false (K1, K2), and superresolutionhep_tpu/
// ops/flash_packed.py::_packed_fwd_kernel (through _packed_fwd, both of its
// softmax variants, with and without LSE) with SEG = true (K7).  What they
// compute is kept:
//   * logits are base 2: Q arrives pre-scaled by scale*log2(e);
//   * robust: padded keys get an additive -1e30 bias, online softmax with a
//     running max, p = exp2(s - m);   no-max: p = exp2(clip(s, -126, 80)) * km;
//   * the row sum l is taken over the fp32 p, p is cast to V's type for the
//     PV product, accumulation is fp32, out = acc / max(l, 1e-30);
//   * key tiles without a valid key are skipped, query tiles without a valid
//     query write zeros, padded query rows are zeroed;
//   * robust can emit the base-2 log-sum-exp m + log2(max(l, 1e-30));
//   * packed (SEG): the pair mask is segment equality (padding cells match
//     each other, their rows are zeroed on output), and only the band of key
//     tiles that can hold a key of the query tile's segments is visited.
//
// What is not carried over: the TPU grid's sequential key axis with a carry
// in scratch memory becomes a loop inside the block (one block per batch row,
// head and query tile; m, l and the output accumulator live in registers);
// the transposed (B, H, D, L) layout, which existed to fill a 128-lane matrix
// unit, becomes (B, L, H, D) views with D contiguous and free strides for B, L
// and H, read by the TMA straight out of the fused projection's (B, L, 3F)
// buffer.  The packed kernel's band, which the TPU computed outside the
// kernel at 512-wide blocks and fed by scalar prefetch, is computed once per
// call for all heads at the kernel's own tile sizes (packed_band_kernel,
// exact: no segment-length cap can cut a segment short).
//
// What bounds it on the card: operations, and beside them the exponentials.
// 4*D flops per visited (query, key) pair against one read of q, k, v and
// one write of out: at L = 2048, D = 64 that is ~1000 flop/byte in bf16, far
// above the H100's ~295.  One fp32 exp2 per pair runs on the special-function
// units at 16 a clock per SM; at D = 64 that takes about as long as the two
// products on the tensor cores.  The bf16 design (flash_fwd_wgmma_kernel):
//   * warp specialisation: one producer warp keeps TMA loads of K/V tiles in
//     flight through a ring of mbarrier full/empty pairs (5 stages, 3 where
//     two blocks share an SM); NC consumer warpgroups of 64 query rows each
//     run the products: NC = 3 (a K/V tile serves 192 queries) for large
//     grids, NC = 1 (two blocks per SM) for small ones; setmaxnreg moves
//     registers from the producer to the consumers.  128-row blocks (NC = 2)
//     were never the fastest of the three on the H100 (PERF.md) and are not
//     built;
//   * S = Q K^T as wgmma.m64n64k16 from shared memory (Q and K K-major, TMA
//     swizzle = the row's 32/64/128 bytes for D = 16/32/64, the same layout
//     in the wgmma descriptors); O += P V with P in registers (the S
//     accumulator repacked to bf16 pairs) and V read MN-major from its
//     [key][d] tile.  Key tiles of 64: 128 measured no faster and spilled;
//   * the exponentials under the products: each consumer issues S_{j+1}
//     before P_j V_j and runs the softmax of tile j+1 while P_j V_j is on the
//     tensor cores; the consumer warpgroups take turns to issue (named
//     barriers), so that one's softmax overlaps another's products;
//   * the producer reads each tile's key mask or segment ids (four tiles
//     ahead), skips dead tiles itself and writes the ids and the tile's index
//     into the stage, so consumers follow its sequence and never disagree
//     with it; a stage with index -1 ends the sequence.
// What holds it now (PERF.md): the softmax's instruction issue and the
// special-function units, at 2.5-3.5x the operation bound.
// The fp32 build (one thread per query row, FMA loops) exists to hold the
// arithmetic tightly against the plain PyTorch version; it uses no tensor
// cores and finds its packed band itself (common.cuh::segment_band).
#include "common.cuh"

namespace srhep {

constexpr float kClipLo = -126.0f;
constexpr float kClipHi = 80.0f;
constexpr float kMaskedLogit = -1000.0f;  // no-max, bf16: 2^-1000 flushes to an exact 0

// ---------------------------------------------------------------------------
// bf16: warp-specialised TMA + wgmma.  Block = NC consumer warpgroups (64
// query rows each) + one producer warpgroup; key tiles of kBK.  In a consumer
// warpgroup, lane = 4*g + t of warp w holds rows 16w + g and 16w + g + 8 of
// the warpgroup's 64, columns 8j + 2t, 8j + 2t + 1 of every 8-wide slice
// (accumulator element 4j + e: e & 2 picks the row, e & 1 the column).
// ---------------------------------------------------------------------------
constexpr int kBK = 64;        // keys per tile: one TMA box, the N of the S product (m64n64k16)
constexpr int kLookahead = 4;  // key tiles whose ids the producer has in flight
constexpr int kTmaRows = 64;   // rows per TMA box (Q, K and V)

static_assert(kBK == kTmaRows, "a K or V tile is one TMA box");

// K/V ring depth: 5 stages with one block per SM, 3 where two blocks share one
template <int NC> __host__ __device__ constexpr int fwd_stages() { return NC == 1 ? 3 : 5; }

template <int NC> struct FwdRegs;  // setmaxnreg budgets: producer + NC * consumer = (NC + 1) * launch bound
template <> struct FwdRegs<1> { static constexpr int kProducer = 24, kConsumer = 232, kMinBlocks = 2; };
template <> struct FwdRegs<3> { static constexpr int kProducer = 32, kConsumer = 160, kMinBlocks = 1; };

// bytes of dynamic shared memory: 1024 of alignment slack, Q, the K/V ring,
// the ring's key ids and tile indices, the barriers
template <int D, int NC> constexpr int fwd_smem_bytes() {
  return 1024 + (NC + 2 * fwd_stages<NC>()) * FwdTiles<D>::kTileBytes + fwd_stages<NC>() * kBK * 4 + 32 +
         (2 * fwd_stages<NC>() + 1) * 8;
}

// Shared-memory descriptors of every wgmma of one step, computed and pinned
// before the step's wgmma.fence, so that no register a wgmma reads is defined
// between its fence and its wait (ptxas then serialises every wgmma).
template <int D> struct StepDescs {
  uint64_t q[D / 16], k[D / 16], v[kBK / 16];
};
template <int D>
__device__ __forceinline__ void make_descs(StepDescs<D>& d, uint32_t qs, uint32_t ks, uint32_t vs) {
  constexpr int SBO = 8 * FwdTiles<D>::kRowBytes, SW = FwdTiles<D>::kSwizzle;
#pragma unroll
  for (int st = 0; st < D / 16; ++st) {  // K-major: the next 16-deep k-step is 32 bytes further
    d.q[st] = gmma_desc(qs + 32 * st, SBO, SW);
    d.k[st] = gmma_desc(ks + 32 * st, SBO, SW);
    asm volatile("" : "+l"(d.q[st]), "+l"(d.k[st]));
  }
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {  // MN-major V: the next 16 keys are 16 rows further
    d.v[kk] = gmma_desc(vs + 16 * kk * FwdTiles<D>::kRowBytes, SBO, SW);
    asm volatile("" : "+l"(d.v[kk]));
  }
}

// S = Q K^T for one warpgroup: (64 x D) x (kBK x D)^T, issued, not waited for
template <int D> __device__ __forceinline__ void issue_qk(float (&s)[kBK / 2], const StepDescs<D>& d) {
#pragma unroll
  for (int st = 0; st < D / 16; ++st) wgmma_ss_m64n64k16(s, d.q[st], d.k[st], st);
}

// O += P V for one warpgroup: P (64 x kBK) from registers, V (kBK x D) [key][d]
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&p)[kBK / 4], const StepDescs<D>& d) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3]};
    pv_mma<D>(o, a, d.v[kk]);
  }
}

// Softmax numerators of one S tile in place (this thread's rows r0, r1; kid
// = the stage's key ids); l, m updated; al = the factor by which the
// accumulator must be rescaled (robust only).
template <bool NOMAX>
__device__ __forceinline__ void tile_softmax(float (&s)[kBK / 2], const int* kid, int t, int qid0, int qid1, float& m0,
                                             float& m1, float& l0, float& l1, float& al0, float& al1) {
  // The softmax is bound by instruction issue (four to six per element
  // beside the exponential), so the mask is a select, not an add or a
  // multiply: robust, a masked logit becomes -1e30, which is what s - 1e30
  // rounds to for every finite logit below 1e22; no-max, the clip's upper
  // bound becomes kMaskedLogit, whose flushed exponential is the exact 0
  // that the multiplication by the mask gave.
  float ps0 = 0.f, ps1 = 0.f;
  if (NOMAX) {
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      const int2 id = *reinterpret_cast<const int2*>(kid + 8 * j + 2 * t);
      s[4 * j] = ex2(fminf(fmaxf(s[4 * j], kClipLo), id.x == qid0 ? kClipHi : kMaskedLogit));
      s[4 * j + 1] = ex2(fminf(fmaxf(s[4 * j + 1], kClipLo), id.y == qid0 ? kClipHi : kMaskedLogit));
      s[4 * j + 2] = ex2(fminf(fmaxf(s[4 * j + 2], kClipLo), id.x == qid1 ? kClipHi : kMaskedLogit));
      s[4 * j + 3] = ex2(fminf(fmaxf(s[4 * j + 3], kClipLo), id.y == qid1 ? kClipHi : kMaskedLogit));
      ps0 += s[4 * j] + s[4 * j + 1];
      ps1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 += ps0;
    l1 += ps1;
    al0 = al1 = 1.f;
  } else {
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      const int2 id = *reinterpret_cast<const int2*>(kid + 8 * j + 2 * t);
      s[4 * j] = id.x == qid0 ? s[4 * j] : kNegInf;
      s[4 * j + 1] = id.y == qid0 ? s[4 * j + 1] : kNegInf;
      s[4 * j + 2] = id.x == qid1 ? s[4 * j + 2] : kNegInf;
      s[4 * j + 3] = id.y == qid1 ? s[4 * j + 3] : kNegInf;
      mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    al0 = ex2(m0 - mn0);
    al1 = ex2(m1 - mn1);
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      s[4 * j] = ex2(s[4 * j] - mn0);
      s[4 * j + 1] = ex2(s[4 * j + 1] - mn0);
      s[4 * j + 2] = ex2(s[4 * j + 2] - mn1);
      s[4 * j + 3] = ex2(s[4 * j + 3] - mn1);
      ps0 += s[4 * j] + s[4 * j + 1];
      ps1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
    m0 = mn0;
    m1 = mn1;
  }
}

// q, k, v: tensor maps over (D, L, H, B) with box (D, 64, 1, 1); band (SEG):
// (B, gridDim.x, 2) int32 = (first key tile, count) per query tile.
template <int D, bool NOMAX, bool SEG, int NC>
__global__ void __launch_bounds__(128 * (NC + 1), FwdRegs<NC>::kMinBlocks)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const void* __restrict__ qmask,
                       const void* __restrict__ kmask, const int* __restrict__ band, bf16* __restrict__ out,
                       float* __restrict__ lse, int H, int Lq, int Lk) {
  using T = FwdTiles<D>;
  constexpr int BQ = 64 * NC, NS = fwd_stages<NC>();
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment: the period of the 128-byte swizzle, which TMA and wgmma both apply by address
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* Qs = reinterpret_cast<bf16*>(base);
  bf16* Ks = Qs + NC * 64 * D;
  bf16* Vs = Ks + NS * kBK * D;  // stage s: K at Ks + s * kBK * D, V at Vs + s * kBK * D
  int* ids = reinterpret_cast<int*>(Vs + NS * kBK * D);  // [NS][kBK]
  int* tile = ids + NS * kBK;                            // [NS], padded to 8
  uint64_t* full = reinterpret_cast<uint64_t*>(tile + 8);
  uint64_t* empty = full + NS;
  uint64_t* qfull = empty + NS;

  const int tid = threadIdx.x;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z, q0 = qt * BQ;

  bool row_valid = false;
  if (tid < BQ) row_valid = q0 + tid < Lq && query_valid<SEG>(qmask, (size_t)b * Lq + q0 + tid);
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
      if (r < Lq) *reinterpret_cast<uint4*>(out + (((size_t)b * Lq + r) * H + h) * D + 8 * (c % V16)) = make_uint4(0u, 0u, 0u, 0u);
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
      int kt_first = 0, kt_last = (Lk + kBK - 1) / kBK - 1;
      if (SEG) {
        const int2 bd = *reinterpret_cast<const int2*>(band + 2 * ((size_t)b * gridDim.x + qt));
        kt_first = bd.x;
        kt_last = bd.x + bd.y - 1;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(qfull, NC * T::kTileBytes);
#pragma unroll
        for (int w = 0; w < NC; ++w) tma_load_4d(Qs + w * 64 * D, &tq, qfull, 0, q0 + 64 * w, h, b);
      }
      auto key = [&](int kpos) { return kpos < Lk ? key_id<SEG>(kmask, (size_t)b * Lk + kpos) : kNoKey; };
      // the ids of the next kLookahead tiles are in flight in registers: a
      // tile's ids are needed (for the skip and the stage) only kLookahead
      // tiles after their load was issued, so the loads' latency does not
      // chain from tile to tile
      constexpr int IPL = kBK / 32;  // ids per lane per tile
      int qa[kLookahead][IPL];
#pragma unroll
      for (int i = 0; i < kLookahead; ++i)
#pragma unroll
        for (int c = 0; c < IPL; ++c) qa[i][c] = kt_first + i <= kt_last ? key((kt_first + i) * kBK + 32 * c + lane) : kNoKey;
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
        for (int i = 0; i + 1 < kLookahead; ++i)
#pragma unroll
          for (int c = 0; c < IPL; ++c) qa[i][c] = qa[i + 1][c];
        const int nk = kt + kLookahead;
#pragma unroll
        for (int c = 0; c < IPL; ++c) qa[kLookahead - 1][c] = nk <= kt_last ? key(nk * kBK + 32 * c + lane) : kNoKey;
        if (!__any_sync(0xffffffffu, live)) continue;  // no live key in this tile
        mbar_wait(&empty[stage], phase ^ 1);
#pragma unroll
        for (int c = 0; c < IPL; ++c) ids[stage * kBK + 32 * c + lane] = id[c];
        if (lane == 0) {
          tile[stage] = kt;
          mbar_arrive_expect_tx(&full[stage], 2 * T::kTileBytes);
          tma_load_4d(Ks + stage * kBK * D, &tk, &full[stage], 0, kt * kBK, h, b);
          tma_load_4d(Vs + stage * kBK * D, &tv, &full[stage], 0, kt * kBK, h, b);
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
    const bool val0 = r0 < Lq && query_valid<SEG>(qmask, (size_t)b * Lq + r0);
    const bool val1 = r1 < Lq && query_valid<SEG>(qmask, (size_t)b * Lq + r1);
    const int qid0 = r0 < Lq ? query_id<SEG>(qmask, (size_t)b * Lq + r0) : kPadSeg;
    const int qid1 = r1 < Lq ? query_id<SEG>(qmask, (size_t)b * Lq + r1) : kPadSeg;

    float o[D / 2], s[kBK / 2];
    uint32_t p[kBK / 4];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf;  // running max of rows r0, r1 (robust only)
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
      StepDescs<D> dsc;
      // S of the first tile and its softmax
      make_descs<D>(dsc, qs, ks0, vs0);
      my_turn();
      wgmma_fence();
      issue_qk<D>(s, dsc);
      wgmma_commit();
      pass_turn();
      wgmma_wait<0>();
      fence_operand(s);
      tile_softmax<NOMAX>(s, ids, t, qid0, qid1, m0, m1, l0, l1, al0, al1);
      pack_p(s, p);
      // every further tile: S_{j+1} issued before P_j V_j, the softmax of
      // j+1 while P_j V_j runs.  The loop body holds no branch between an
      // issue and its wait, so that ptxas can keep the products in flight.
      while (true) {
        const int ns = stage + 1 == NS ? 0 : stage + 1;
        const unsigned nph = ns == 0 ? phase ^ 1 : phase;
        mbar_wait(&full[ns], nph);
        if (tile[ns] < 0) break;
        StepDescs<D> dq;  // K of the next tile, V of this one
        make_descs<D>(dq, qs, ks0 + ns * kBK * T::kRowBytes, vs0 + stage * kBK * T::kRowBytes);
        fence_operand(s);
        fence_operand(o);
        fence_operand(p);
        my_turn();
        wgmma_fence();
        issue_qk<D>(s, dq);
        wgmma_commit();
        issue_pv<D>(o, p, dq);
        wgmma_commit();
        pass_turn();
        wgmma_wait<1>();
        fence_operand(s);
        tile_softmax<NOMAX>(s, ids + ns * kBK, t, qid0, qid1, m0, m1, l0, l1, al0, al1);
        wgmma_wait<0>();
        fence_operand(o);
        fence_operand(p);
        // robust: rescale only where a row's max moved (al = 1 exactly elsewhere)
        if (!NOMAX && !__all_sync(0xffffffffu, al0 == 1.f && al1 == 1.f)) {
#pragma unroll
          for (int i = 0; i < D / 2; i += 4) {
            o[i] *= al0;
            o[i + 1] *= al0;
            o[i + 2] *= al1;
            o[i + 3] *= al1;
          }
        }
        mbar_arrive(&empty[stage]);
        pack_p(s, p);
        stage = ns;
        phase = nph;
      }
      // the last tile's P V
      make_descs<D>(dsc, qs, ks0, vs0 + stage * kBK * T::kRowBytes);
      fence_operand(o);
      fence_operand(p);
      my_turn();
      wgmma_fence();
      issue_pv<D>(o, p, dsc);
      wgmma_commit();
      pass_turn();
      wgmma_wait<0>();
      fence_operand(o);
    }
    if (kPingPong && wg == 0) named_bar_sync(1, 256);

    // row sums across the 4 threads that share a row
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    const float f0 = val0 ? 1.f : 0.f, f1 = val1 ? 1.f : 0.f;
    bf16* o0p = out + (((size_t)b * Lq + r0) * H + h) * D;
    bf16* o1p = out + (((size_t)b * Lq + r1) * H + h) * D;
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd) {
      if (r0 < Lq)
        *reinterpret_cast<__nv_bfloat162*>(o0p + 8 * jd + 2 * t) =
            __floats2bfloat162_rn(o[4 * jd] / d0 * f0, o[4 * jd + 1] / d0 * f0);
      if (r1 < Lq)
        *reinterpret_cast<__nv_bfloat162*>(o1p + 8 * jd + 2 * t) =
            __floats2bfloat162_rn(o[4 * jd + 2] / d1 * f1, o[4 * jd + 3] / d1 * f1);
    }
    if (!NOMAX && lse != nullptr && t == 0) {
      if (r0 < Lq) lse[((size_t)b * H + h) * Lq + r0] = m0 + log2f(d0);
      if (r1 < Lq) lse[((size_t)b * H + h) * Lq + r1] = m1 + log2f(d1);
    }
  }
}

// The band of every (row, BQ-query tile) of a segment-packed batch over BK-key
// tiles, for all heads at once: band[b][qt] = (first key tile, count) of the
// tiles whose [min, max] valid segment id overlaps the query tile's (the JAX
// package's band_ranges; interior all-pad tiles lie inside, count 0 when the
// query tile holds no valid cell; the last query tile may be ragged).  One
// block per row: the row's ids are staged in shared memory with 16-byte
// loads, a warp reduces each tile's [min, max] with shuffles, and a warp
// finds each query tile's first and last overlapping key tile by ballot.
// S a multiple of BK.  Bound by latency: one pass over the (B, S) ids.
constexpr int kBandThreads = 256;
__global__ void __launch_bounds__(kBandThreads) packed_band_kernel(const int* __restrict__ seg,
                                                                   int* __restrict__ band, int S, int BQ, int BK) {
  extern __shared__ int sh[];  // the row's S ids, then [min, max] of the nK key tiles and the nQ query tiles
  const int b = blockIdx.x, nQ = (S + BQ - 1) / BQ, nK = S / BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nw = kBandThreads / 32;
  int* ids = sh;
  int* kr = sh + S;       // [nK][2]
  int* qr = kr + 2 * nK;  // [nQ][2]
  constexpr int kBigId = 1 << 30;
  const int4* row4 = reinterpret_cast<const int4*>(seg + (size_t)b * S);
#pragma unroll 4
  for (int i = threadIdx.x; i < S / 4; i += kBandThreads) reinterpret_cast<int4*>(ids)[i] = row4[i];
  __syncthreads();
  for (int j = warp; j < nK + nQ; j += nw) {
    const bool is_key = j < nK;
    const int t0 = is_key ? j * BK : (j - nK) * BQ, n = is_key ? BK : min(BQ, S - t0);
    int lo = kBigId, hi = -kBigId;
    for (int i = lane; i < n; i += 32) {
      const int x = ids[t0 + i];
      if (x != kPadSeg) {
        lo = min(lo, x);
        hi = max(hi, x);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    if (lane == 0) {
      int* r = is_key ? kr + 2 * j : qr + 2 * (j - nK);
      r[0] = lo;
      r[1] = hi;
    }
  }
  __syncthreads();
  for (int qt = warp; qt < nQ; qt += nw) {
    const int lo = qr[2 * qt], hi = qr[2 * qt + 1];
    int first = -1, last = -1;
    for (int j0 = 0; j0 < nK; j0 += 32) {
      const int j = j0 + lane;
      const unsigned m = __ballot_sync(0xffffffffu, j < nK && kr[2 * j] <= hi && kr[2 * j + 1] >= lo);
      if (m) {
        if (first < 0) first = j0 + __ffs(m) - 1;
        last = j0 + 31 - __clz(m);
      }
    }
    if (lane == 0) {
      band[2 * ((size_t)b * nQ + qt)] = first < 0 ? 0 : first;
      band[2 * ((size_t)b * nQ + qt) + 1] = first < 0 ? 0 : last - first + 1;
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: one thread per query row, 128 rows per block, key tiles of 32 through
// shared memory (every thread reads the same K/V element: a broadcast).
// ---------------------------------------------------------------------------
template <int D, bool NOMAX, bool SEG>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     const void* __restrict__ qmask, const void* __restrict__ kmask, float* __restrict__ out,
                     float* __restrict__ lse, int H, int Lq, int Lk, Strides qs, Strides ks, Strides vs) {
  constexpr int BQ = kThreads, BK = 32;
  __shared__ __align__(16) float Ks[BK * D];
  __shared__ __align__(16) float Vs[BK * D];
  __shared__ int kid[BK];

  const int tid = threadIdx.x;
  const int row = blockIdx.x * BQ + tid, h = blockIdx.y, b = blockIdx.z;
  const bool in_range = row < Lq;
  const bool my_valid = in_range && query_valid<SEG>(qmask, (size_t)b * Lq + row);
  const int my_qid = in_range ? query_id<SEG>(qmask, (size_t)b * Lq + row) : kPadSeg;
  const int tile_has_query = __syncthreads_or(my_valid);
  float* op = out + (((size_t)b * Lq + row) * H + h) * D;

  if (!tile_has_query) {
    if (in_range) {
#pragma unroll
      for (int d = 0; d < D; d += 4) *reinterpret_cast<float4*>(op + d) = make_float4(0.f, 0.f, 0.f, 0.f);
      if (lse != nullptr) lse[((size_t)b * H + h) * Lq + row] = kNegInf;
    }
    return;
  }

  float qr[D], acc[D];
  {
    const float* qp = q + (size_t)b * qs.b + (size_t)(in_range ? row : 0) * qs.l + (size_t)h * qs.h;
#pragma unroll
    for (int d = 0; d < D; d += 4) {
      const float4 x = in_range ? *reinterpret_cast<const float4*>(qp + d) : make_float4(0.f, 0.f, 0.f, 0.f);
      qr[d] = x.x;
      qr[d + 1] = x.y;
      qr[d + 2] = x.z;
      qr[d + 3] = x.w;
    }
  }
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;
  float m = kNegInf, l = 0.f;

  const int2 band = SEG ? segment_band<BK>(static_cast<const int*>(kmask) + (size_t)b * Lk, Lk, my_qid, my_valid, 0, false)
                        : make_int2(0, (Lk + BK - 1) / BK - 1);
  for (int kt = band.x; kt <= band.y; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    int my_kid = kNoKey;
    if (tid < BK) {
      my_kid = (k0 + tid) < Lk ? key_id<SEG>(kmask, (size_t)b * Lk + k0 + tid) : kNoKey;
      kid[tid] = my_kid;
    }
    if (!__syncthreads_or(my_kid >= 0)) continue;

    constexpr int CPR = D / 4;
    for (int c = tid; c < BK * CPR; c += kThreads) {
      const int r = c / CPR, cc = c % CPR;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + r < Lk) {
        kv = *reinterpret_cast<const float4*>(k + (size_t)b * ks.b + (size_t)(k0 + r) * ks.l + (size_t)h * ks.h + 4 * cc);
        vv = *reinterpret_cast<const float4*>(v + (size_t)b * vs.b + (size_t)(k0 + r) * vs.l + (size_t)h * vs.h + 4 * cc);
      }
      *reinterpret_cast<float4*>(&Ks[r * D + 4 * cc]) = kv;
      *reinterpret_cast<float4*>(&Vs[r * D + 4 * cc]) = vv;
    }
    __syncthreads();

    float s[BK];
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float a = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(&Ks[j * D + d]);
        a = fmaf(qr[d], kk.x, a);
        a = fmaf(qr[d + 1], kk.y, a);
        a = fmaf(qr[d + 2], kk.z, a);
        a = fmaf(qr[d + 3], kk.w, a);
      }
      s[j] = a;
    }

    float psum = 0.f;
    if (NOMAX) {
#pragma unroll
      for (int j = 0; j < BK; ++j) {
        s[j] = exp2f(fminf(fmaxf(s[j], kClipLo), kClipHi)) * (kid[j] == my_qid ? 1.f : 0.f);
        psum += s[j];
      }
      l += psum;
    } else {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < BK; ++j) {
        s[j] += kid[j] == my_qid ? 0.f : -kBig;
        mx = fmaxf(mx, s[j]);
      }
      const float mn = fmaxf(m, mx);
      const float al = exp2f(m - mn);
#pragma unroll
      for (int j = 0; j < BK; ++j) {
        s[j] = exp2f(s[j] - mn);
        psum += s[j];
      }
      l = l * al + psum;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= al;
      m = mn;
    }

#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = s[j];
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&Vs[j * D + d]);
        acc[d] = fmaf(p, vv.x, acc[d]);
        acc[d + 1] = fmaf(p, vv.y, acc[d + 1]);
        acc[d + 2] = fmaf(p, vv.z, acc[d + 2]);
        acc[d + 3] = fmaf(p, vv.w, acc[d + 3]);
      }
    }
  }

  if (in_range) {
    const float den = fmaxf(l, 1e-30f);
    const float f = my_valid ? 1.f : 0.f;
#pragma unroll
    for (int d = 0; d < D; d += 4)
      *reinterpret_cast<float4*>(op + d) =
          make_float4(acc[d] / den * f, acc[d + 1] / den * f, acc[d + 2] / den * f, acc[d + 3] / den * f);
    if (!NOMAX && lse != nullptr) lse[((size_t)b * H + h) * Lq + row] = m + log2f(den);
  }
}

// ---------------------------------------------------------------------------
// host side of the bf16 kernel: tensor maps, shared-memory opt-in, launch
// ---------------------------------------------------------------------------
template <int D, bool NOMAX, bool SEG, int NC> static cudaError_t opt_in_smem() {
  return cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D, NOMAX, SEG, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              fwd_smem_bytes<D, NC>());
}

// Every instantiation's shared-memory opt-in, once per process, on the
// first call (which the wrappers make eagerly, never inside a graph capture).
template <int D> static cudaError_t opt_in_head_dim() {
  cudaError_t e = cudaSuccess;
#define SRHEP_OPT_IN(NM, SG)                                   \
  if (e == cudaSuccess) e = opt_in_smem<D, NM, SG, 1>();      \
  if (e == cudaSuccess) e = opt_in_smem<D, NM, SG, 3>();
  SRHEP_OPT_IN(false, false)
  SRHEP_OPT_IN(true, false)
  SRHEP_OPT_IN(false, true)
  SRHEP_OPT_IN(true, true)
#undef SRHEP_OPT_IN
  return e;
}
constexpr int kBandMaxSmem = 200 * 1024;  // rows of up to ~50k cells
static cudaError_t opt_in_all() {
  static cudaError_t done = cudaErrorNotReady;
  if (done == cudaErrorNotReady) {
    done = cudaFuncSetAttribute(packed_band_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBandMaxSmem);
    if (done == cudaSuccess) done = opt_in_head_dim<16>();
    if (done == cudaSuccess) done = opt_in_head_dim<32>();
    if (done == cudaSuccess) done = opt_in_head_dim<64>();
  }
  return done;
}

template <int D, bool NOMAX, bool SEG>
static int launch_flash_bf16(const void* q, const void* k, const void* v, const void* qmask, const void* kmask,
                             const int* band, void* out, void* lse, int B, int H, int Lq, int Lk, Strides qs,
                             Strides ks, Strides vs, int block_q, cudaStream_t stream) {
  const cudaError_t opt = opt_in_all();
  if (opt != cudaSuccess) return (int)opt;
  CUtensorMap tq, tk, tv;
  if (!encode_operand(&tq, q, D, Lq, H, B, qs) || !encode_operand(&tk, k, D, Lk, H, B, ks) ||
      !encode_operand(&tv, v, D, Lk, H, B, vs))
    return (int)cudaErrorInvalidValue;
  if (block_q == 192) {
    dim3 grid((Lq + 191) / 192, H, B);
    flash_fwd_wgmma_kernel<D, NOMAX, SEG, 3><<<grid, 512, fwd_smem_bytes<D, 3>(), stream>>>(
        tq, tk, tv, qmask, kmask, band, static_cast<bf16*>(out), static_cast<float*>(lse), H, Lq, Lk);
  } else if (block_q == 64) {
    dim3 grid((Lq + 63) / 64, H, B);
    flash_fwd_wgmma_kernel<D, NOMAX, SEG, 1><<<grid, 256, fwd_smem_bytes<D, 1>(), stream>>>(
        tq, tk, tv, qmask, kmask, band, static_cast<bf16*>(out), static_cast<float*>(lse), H, Lq, Lk);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <int D, bool NOMAX, bool SEG>
static int launch_flash(const void* q, const void* k, const void* v, const void* qmask, const void* kmask,
                        const int* band, void* out, void* lse, int B, int H, int Lq, int Lk, Strides qs, Strides ks,
                        Strides vs, int is_bf16, int block_q, cudaStream_t stream) {
  if (is_bf16)
    return launch_flash_bf16<D, NOMAX, SEG>(q, k, v, qmask, kmask, band, out, lse, B, H, Lq, Lk, qs, ks, vs, block_q,
                                            stream);
  dim3 grid((Lq + kThreads - 1) / kThreads, H, B);
  flash_fwd_f32_kernel<D, NOMAX, SEG><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v), qmask, kmask,
      static_cast<float*>(out), static_cast<float*>(lse), H, Lq, Lk, qs, ks, vs);
  return (int)cudaGetLastError();
}

}  // namespace srhep

// q (B, Lq, H, D), k, v (B, Lk, H, D) as strided views with D contiguous
// (strides in elements, 16-byte aligned); qm (B, Lq), km (B, Lk) fp32;
// out (B, Lq, H, D) contiguous; lse (B, H, Lq) fp32 or null.  D in {16, 32, 64}.
// block_q: query rows per block of the bf16 kernel (64 or 192; ignored in
// fp32).  Returns cudaGetLastError().
extern "C" int srhep_flash_fwd(const void* q, const void* k, const void* v, const void* qm, const void* km,
                               void* out, void* lse, int B, int H, int Lq, int Lk, int D, long long qsb,
                               long long qsl, long long qsh, long long ksb, long long ksl, long long ksh,
                               long long vsb, long long vsl, long long vsh, int is_bf16, int nomax, int block_q,
                               void* stream) {
  using namespace srhep;
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  if (nomax && lse != nullptr) return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qsl, qsh}, ks{ksb, ksl, ksh}, vs{vsb, vsl, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SRHEP_FLASH_CASE(DD)                                                                                        \
  case DD:                                                                                                          \
    return nomax ? launch_flash<DD, true, false>(q, k, v, qm, km, nullptr, out, lse, B, H, Lq, Lk, qs, ks, vs,     \
                                                 is_bf16, block_q, s)                                               \
                 : launch_flash<DD, false, false>(q, k, v, qm, km, nullptr, out, lse, B, H, Lq, Lk, qs, ks, vs,    \
                                                  is_bf16, block_q, s);
  switch (D) {
    SRHEP_FLASH_CASE(16)
    SRHEP_FLASH_CASE(32)
    SRHEP_FLASH_CASE(64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SRHEP_FLASH_CASE
}

// The band table of a packed batch (K7's bf16 kernel): seg (B, S) int32,
// band (B, S / block_q, 2) int32 = (first key tile, count) over block_k-wide
// key tiles.  Returns cudaGetLastError().
extern "C" int srhep_packed_band(const void* seg, void* band, int B, int S, int block_q, int block_k, void* stream) {
  using namespace srhep;
  if (B <= 0 || S <= 0 || block_q <= 0 || block_k <= 0 || S % block_k || S % 4) return (int)cudaErrorInvalidValue;
  const size_t smem = (S + 2 * (S / block_k) + 2 * ((S + block_q - 1) / block_q)) * sizeof(int);
  if (smem > kBandMaxSmem) return (int)cudaErrorInvalidValue;
  const cudaError_t opt = opt_in_all();
  if (opt != cudaSuccess) return (int)opt;
  packed_band_kernel<<<B, kBandThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(seg), static_cast<int*>(band), S, block_q, block_k);
  return (int)cudaGetLastError();
}

// Segment-packed rows (K7): q, k, v (B, S, H, D) as strided views with D
// contiguous (strides in elements, 16-byte aligned); seg (B, S) int32, -1 on
// padding, valid ids nondecreasing along each row; band (bf16 only): the
// srhep_packed_band table at block_q x 64 tiles; out (B, S, H, D)
// contiguous, zero on padding; lse (B, H, S) fp32 or null (robust only).
// D in {16, 32, 64}.  Returns cudaGetLastError().
extern "C" int srhep_packed_fwd(const void* q, const void* k, const void* v, const void* seg, const void* band,
                                void* out, void* lse, int B, int H, int S, int D, long long qsb, long long qsl,
                                long long qsh, long long ksb, long long ksl, long long ksh, long long vsb,
                                long long vsl, long long vsh, int is_bf16, int nomax, int block_q, void* stream) {
  using namespace srhep;
  if (B <= 0 || H <= 0 || S <= 0 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  if (nomax && lse != nullptr) return (int)cudaErrorInvalidValue;
  if (is_bf16 && band == nullptr) return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qsl, qsh}, ks{ksb, ksl, ksh}, vs{vsb, vsl, vsh};
  const int* bd = static_cast<const int*>(band);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SRHEP_PACKED_CASE(DD)                                                                                      \
  case DD:                                                                                                         \
    return nomax ? launch_flash<DD, true, true>(q, k, v, seg, seg, bd, out, lse, B, H, S, S, qs, ks, vs, is_bf16, \
                                                block_q, st)                                                       \
                 : launch_flash<DD, false, true>(q, k, v, seg, seg, bd, out, lse, B, H, S, S, qs, ks, vs,         \
                                                 is_bf16, block_q, st);
  switch (D) {
    SRHEP_PACKED_CASE(16)
    SRHEP_PACKED_CASE(32)
    SRHEP_PACKED_CASE(64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SRHEP_PACKED_CASE
}
