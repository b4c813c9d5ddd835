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
// products on the tensor cores.  The bf16 kernel (flash_fwd_wgmma_kernel) is
// the shared forward body of flash_fwd.cuh (its design is described there)
// with this file's policy, FwdSoftmax: the mask a select on the key words the
// producer carries (key mask or segment ids), dead key tiles skipped.
// What holds it now (PERF.md): the softmax's instruction issue and the
// special-function units, at 2.5-3.5x the operation bound.
// The fp32 build (flash_fwd_f32_kernel, below: PF's default precision, SR's
// "default" fp32) takes its products on the tensor cores as three-term TF32
// splits (tf32_attention.cuh), fp32-faithful; its section says what holds it.
#include "flash_fwd.cuh"
#include "tf32_attention.cuh"

namespace srhep {

constexpr float kClipLo = -126.0f;
constexpr float kClipHi = 80.0f;
constexpr float kMaskedLogit = -1000.0f;  // no-max, bf16: 2^-1000 flushes to an exact 0

// ---------------------------------------------------------------------------
// bf16: the forward body of flash_fwd.cuh with the shipped softmax.
// ---------------------------------------------------------------------------
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

// The shipped kernels' policy of the forward body (flash_fwd.cuh): key
// tiles of kBK, the key mask or segment ids as key words (dead tiles
// skipped), tile_softmax, output (B, Lq, H, D) contiguous.
template <bool NOMAX, bool SEG> struct FwdSoftmax {
  static constexpr int kBK = ::srhep::kBK;
  static constexpr bool kSeg = SEG, kSkipDead = true, kOverlap = true, kRescale = !NOMAX, kLse = !NOMAX, kRowSum = false;
  static __device__ __forceinline__ int key(const void* kmask, size_t i) { return key_id<SEG>(kmask, i); }
  static __device__ __forceinline__ bool query_valid(const void* qmask, size_t i) {
    return ::srhep::query_valid<SEG>(qmask, i);
  }
  static __device__ __forceinline__ int query_id(const void* qmask, size_t i) { return ::srhep::query_id<SEG>(qmask, i); }
  static __device__ __forceinline__ void tile(float (&s)[kBK / 2], const int* kid, int t, int qid0, int qid1, float& m0,
                                              float& m1, float& l0, float& l1, float& al0, float& al1) {
    tile_softmax<NOMAX>(s, kid, t, qid0, qid1, m0, m1, l0, l1, al0, al1);
  }
  static __device__ __forceinline__ void pack(const float (&s)[kBK / 2], uint32_t (&p)[kBK / 4]) { pack_p(s, p); }
  static __device__ __forceinline__ size_t out_row(int b, int h, int r, int H, int Lq) {
    return ((size_t)b * Lq + r) * H + h;
  }
};

// q, k, v: tensor maps over (D, L, H, B) with box (D, 64, 1, 1); band (SEG):
// (B, gridDim.x, 2) int32 = (first key tile, count) per query tile.
template <int D, bool NOMAX, bool SEG, int NC>
__global__ void __launch_bounds__(128 * (NC + 1), FwdRegs<NC>::kMinBlocks)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const void* __restrict__ qmask,
                       const void* __restrict__ kmask, const int* __restrict__ band, bf16* __restrict__ out,
                       float* __restrict__ lse, int H, int Lq, int Lk) {
  fwd_wgmma_body<D, NC, FwdSoftmax<NOMAX, SEG>>(tq, tk, tv, qmask, kmask, band, out, lse, H, Lq, Lk);
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
// fp32 (K1, K2, K7 on fp32 operands: PF's default precision, SR's "default"
// fp32 inference and training): the products on the tensor cores as
// three-term TF32 splits (tf32_attention.cuh), fp32-faithful.
//
// What bounds it: at D = 16 (PF) the least time is the split products on
// the tensor cores (3 TF32 products for each of the 4*D flops a pair: 7.5 us
// at (32, 640, 4, 16), against one exp2 a pair on the special-function units,
// 4.6 us, and the bytes, 6.3 us).  mma.sync reaches about half of the TF32
// rate that figure assumes (wgmma's), and beside the products each warp
// splits every K, V and P value it reads (five instructions a value) and runs
// the softmax's five to six instructions a pair.  What holds it on the card
// (PERF.md §6): a tile's S and P V phases wait on the tensor cores, its
// softmax on instruction issue, and the warps of an SM overlap the two only
// in part.  The design: a block of 4 warps owns 64 query rows, 16 a warp; Q
// is split once into registers (the A fragments of S = Q K^T); K is read as
// 16-byte B fragments (the summed head dim permuted within 16-column groups,
// the same order for Q and K); P goes from S's accumulator into the A operand
// of P V with no shuffle, V's rows read in the matching order
// (tf32_attention.cuh); each 8-key step of O is summed apart and added in
// fp32 (add_frag); the running max and row sums stay on the accumulator's
// rows (quad shuffles).  K/V tiles and their key ids stream through a
// two-stage cp.async ring (one barrier a tile) whose rows are padded so that
// every fragment read is free of bank conflicts, and only key tiles with a
// key of the block's ids are visited.
// ---------------------------------------------------------------------------
constexpr int kFwdTerms = 3;  // terms of each split product (1: single TF32)

template <int D> struct FwdF32 {
  // ring depth: three or four stages, and the next tile's S issued beside
  // this tile's softmax, gained nothing on the card (PERF.md)
  static constexpr int kStages = 2;
  static constexpr int kLdK = D % 32 == 16 ? D : D + 16;  // 16-byte reads, rows g and g+1 16 banks apart
  static constexpr int kLdV = D + 4;                      // 4-byte reads of rows 2t, 2t+1 at column g
  static constexpr int kKBytes = kF32Tile * kLdK * 4, kVBytes = kF32Tile * kLdV * 4;
  static constexpr int kStageBytes = kKBytes + kVBytes + kF32Tile * 4;  // K, V, key ids
  // at D = 64 Q's lo fragments wait in shared memory, a thread's own slots
  // (in registers beside the hi ones, O and S, the build spilled)
  static constexpr bool kQloShared = D == 64;
  static constexpr int kQloBytes = kQloShared ? kF32Rows * D * 4 : 0;
  static constexpr int smem_bytes(int n_tiles) {
    return kStages * kStageBytes + kQloBytes + ((n_tiles + 15) & ~15);
  }
};

// both rows of an accumulator fragment times their factors (rows g, g + 8)
__device__ __forceinline__ void rescale_rows(float (&o)[4], float a0, float a1) {
  o[0] *= a0;
  o[1] *= a0;
  o[2] *= a1;
  o[3] *= a1;
}

// q, k, v: (B, L, H, D) fp32 views with D contiguous; one block per (query
// tile of 64, head, batch row); dynamic shared memory FwdF32<D>::smem_bytes.
template <int D, bool NOMAX, bool SEG>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     const void* __restrict__ qmask, const void* __restrict__ kmask, float* __restrict__ out,
                     float* __restrict__ lse, int H, int Lq, int Lk, Strides qs, Strides ks, Strides vs) {
  using T = FwdF32<D>;
  constexpr int KS = D / 8, NT = D / 8, NJ = kF32Tile / 8;  // k-steps over D, output n-tiles, key n-tiles
  // key steps a softmax pass takes: from D = 32 a tile goes in two halves of
  // 32 keys (the registers of S for 64 keys beside Q's split fragments and O
  // spilled)
  constexpr int NJS = D >= 32 ? NJ / 2 : NJ;
  constexpr int NS = T::kStages;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* qlo_s = reinterpret_cast<uint4*>(smem + NS * T::kStageBytes);  // [warp][k-step][lane] (kQloShared)
  unsigned char* live = smem + NS * T::kStageBytes + T::kQloBytes;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z, nkt = (Lk + kF32Tile - 1) / kF32Tile;
  const int r0 = blockIdx.x * kF32Rows + warp * 16 + gq, r1 = r0 + 8;  // this thread's rows
  const bool in0 = r0 < Lq, in1 = r1 < Lq;
  const size_t qrow = (size_t)b * Lq;
  const bool val0 = in0 && query_valid<SEG>(qmask, qrow + r0), val1 = in1 && query_valid<SEG>(qmask, qrow + r1);
  // the ids the rows compare the keys' with: segment ids, or with padding
  // masks 0 for every row (a constant: one compare a key serves both rows)
  const int qid0 = SEG ? (in0 ? query_id<SEG>(qmask, qrow + r0) : kPadSeg) : 0;
  const int qid1 = SEG ? (in1 ? query_id<SEG>(qmask, qrow + r1) : kPadSeg) : 0;
  // Q's A fragments, split once (loaded before the first barrier, so that
  // their latency overlaps it): k-step 2m + e reads head-dim columns
  // 16m + 4t + 2e (a0, a1) and 16m + 4t + 2e + 1 (a2, a3)
  uint32_t qh[KS][4], ql[T::kQloShared ? 1 : KS][4];
#pragma unroll
  for (int m = 0; m < D / 16; ++m) {
    const float* p0 = q + (size_t)b * qs.b + (size_t)(in0 ? r0 : 0) * qs.l + (size_t)h * qs.h + 16 * m + 4 * tq;
    const float* p1 = q + (size_t)b * qs.b + (size_t)(in1 ? r1 : 0) * qs.l + (size_t)h * qs.h + 16 * m + 4 * tq;
    const float4 x0 = in0 ? *reinterpret_cast<const float4*>(p0) : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 x1 = in1 ? *reinterpret_cast<const float4*>(p1) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      uint32_t l[4];
      split_frag(e ? x0.z : x0.x, e ? x1.z : x1.x, e ? x0.w : x0.y, e ? x1.w : x1.y, qh[2 * m + e], l);
      if constexpr (T::kQloShared) {
        qlo_s[(warp * KS + 2 * m + e) * 32 + lane] = make_uint4(l[0], l[1], l[2], l[3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) ql[T::kQloShared ? 0 : 2 * m + e][i] = l[i];
      }
    }
  }
  // padding masks: a key tile is live if it holds a valid key, whatever the queries
  if (!SEG) flag_live_tiles<SEG>(kmask, (size_t)b * Lk, Lk, make_int2(0, 0), live);
  const int2 ids = block_id_range(val0, qid0, val1, qid1);
  const bool dead = ids.x > ids.y;  // no valid query: zeros, LSE -inf

  float o[NT][4], m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;

  if (!dead) {
    if (SEG) {  // segments: a key tile is live if it holds a key of the block's segments
      flag_live_tiles<SEG>(kmask, (size_t)b * Lk, Lk, ids, live);
      __syncthreads();
    }
    auto stage = [&](int s) { return smem + s * T::kStageBytes; };
    auto issue = [&](int s, int kt) {
      unsigned char* st = stage(s);
      tile_async<D, T::kLdK>(reinterpret_cast<float*>(st), k, ks, b, h, kt * kF32Tile, Lk);
      tile_async<D, T::kLdV>(reinterpret_cast<float*>(st + T::kKBytes), v, vs, b, h, kt * kF32Tile, Lk);
      row_async(st + T::kKBytes + T::kVBytes, static_cast<const unsigned char*>(kmask) + (size_t)b * Lk * 4,
                kt * kF32Tile, Lk);
    };
    // ---- S = Q K^T of key steps j0 .. j0 + NJS - 1 of the tile in stage st:
    // 16 rows x 8 NJS keys a warp (c: rows g, g+8; keys 8j + 2t, +1)
    // Q's lo fragment of k-step kk: registers, or this thread's shared slot
    auto q_lo = [&](int kk) {
      if constexpr (T::kQloShared) {
        const uint4 a = qlo_s[(warp * KS + kk) * 32 + lane];
        return SplitFrag{{a.x, a.y, a.z, a.w}};
      } else {
        return SplitFrag{{ql[kk][0], ql[kk][1], ql[kk][2], ql[kk][3]}};
      }
    };
    auto s_tile = [&](float (&sc)[NJS][4], int st, int j0) {
      const float* Ks = reinterpret_cast<const float*>(stage(st)) + 8 * j0 * T::kLdK;
#pragma unroll
      for (int j = 0; j < NJS; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int m = 0; m < D / 16; ++m) {
        const SplitFrag lo0 = q_lo(2 * m), lo1 = q_lo(2 * m + 1);
#pragma unroll
        for (int j = 0; j < NJS; ++j) {
          const float4 kv = *reinterpret_cast<const float4*>(Ks + (8 * j + gq) * T::kLdK + 16 * m + 4 * tq);
          uint32_t bh[4], bl[4];
          split_frag(kv.x, kv.y, kv.z, kv.w, bh, bl);
          mma_split<kFwdTerms>(sc[j], qh[2 * m], lo0.r, bh[0], bh[1], bl[0], bl[1]);
          mma_split<kFwdTerms>(sc[j], qh[2 * m + 1], lo1.r, bh[2], bh[3], bl[2], bl[3]);
        }
      }
    };
    // ---- softmax numerators on the accumulator (the mask a select), then
    // O += P V: P's accumulator is the A operand (keys 8j + 2t, +1), V's rows
    // read in that order
    auto softmax_pv = [&](float (&sc)[NJS][4], int st, int j0) {
      const int* kid = reinterpret_cast<const int*>(stage(st) + T::kKBytes + T::kVBytes) + 8 * j0;
      float ps0 = 0.f, ps1 = 0.f;
      if (NOMAX) {
#pragma unroll
        for (int j = 0; j < NJS; ++j) {
          const int2 ki = *reinterpret_cast<const int2*>(kid + 8 * j + 2 * tq);
          sc[j][0] = ex2(fminf(fmaxf(sc[j][0], kClipLo), ki.x == qid0 ? kClipHi : kMaskedLogit));
          sc[j][1] = ex2(fminf(fmaxf(sc[j][1], kClipLo), ki.y == qid0 ? kClipHi : kMaskedLogit));
          sc[j][2] = ex2(fminf(fmaxf(sc[j][2], kClipLo), ki.x == qid1 ? kClipHi : kMaskedLogit));
          sc[j][3] = ex2(fminf(fmaxf(sc[j][3], kClipLo), ki.y == qid1 ? kClipHi : kMaskedLogit));
          ps0 += sc[j][0] + sc[j][1];
          ps1 += sc[j][2] + sc[j][3];
        }
        l0 += ps0;
        l1 += ps1;
      } else {
        float mx0 = m0, mx1 = m1;
#pragma unroll
        for (int j = 0; j < NJS; ++j) {
          const int2 ki = *reinterpret_cast<const int2*>(kid + 8 * j + 2 * tq);
          sc[j][0] = ki.x == qid0 ? sc[j][0] : kNegInf;
          sc[j][1] = ki.y == qid0 ? sc[j][1] : kNegInf;
          sc[j][2] = ki.x == qid1 ? sc[j][2] : kNegInf;
          sc[j][3] = ki.y == qid1 ? sc[j][3] : kNegInf;
          mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
          mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
        }
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
        const float al0 = ex2(m0 - mx0), al1 = ex2(m1 - mx1);
#pragma unroll
        for (int j = 0; j < NJS; ++j) {
          sc[j][0] = ex2(sc[j][0] - mx0);
          sc[j][1] = ex2(sc[j][1] - mx0);
          sc[j][2] = ex2(sc[j][2] - mx1);
          sc[j][3] = ex2(sc[j][3] - mx1);
          ps0 += sc[j][0] + sc[j][1];
          ps1 += sc[j][2] + sc[j][3];
        }
        l0 = l0 * al0 + ps0;
        l1 = l1 * al1 + ps1;
        m0 = mx0;
        m1 = mx1;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) rescale_rows(o[nt], al0, al1);  // the running max moved
      }
      const float* Vs = reinterpret_cast<const float*>(stage(st) + T::kKBytes) + 8 * j0 * T::kLdV;
#pragma unroll
      for (int j = 0; j < NJS; ++j) {
        uint32_t ph[4], pl[4];
        split_frag(sc[j][0], sc[j][2], sc[j][1], sc[j][3], ph, pl);
        const float* v0 = Vs + (8 * j + 2 * tq) * T::kLdV + gq;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          uint32_t bh0, bl0, bh1, bl1;
          split_tf32(v0[8 * nt], bh0, bl0);
          split_tf32(v0[T::kLdV + 8 * nt], bh1, bl1);
          float t[4] = {0.f, 0.f, 0.f, 0.f};  // the step summed apart (add_frag)
          mma_split<kFwdTerms>(t, ph, pl, bh0, bh1, bl0, bl1);
          add_frag(o[nt], t);
        }
      }
    };
    auto land = [&](int st, int kt) {  // this thread's share of the tile's ids, once its copies landed
      ids_in_place<SEG, true>(reinterpret_cast<int*>(stage(st) + T::kKBytes + T::kVBytes), kt * kF32Tile, Lk);
    };

    // the ring: NS stages; tile i in stage i % NS.  One barrier a tile:
    // after it, every warp is past tile i - 1, whose stage takes the copy of
    // tile i + NS - 1.
    TileQueue<NS> tq_;
#pragma unroll
    for (int s = 0; s < NS - 1; ++s) {
      tq_.pend[s] = tq_.advance(live, nkt);
      if (tq_.pend[s] < nkt) issue(s, tq_.pend[s]);
      cp_async_commit();
    }
    for (int i = 0; tq_.pend[0] < nkt; ++i) {
      cp_async_wait<NS - 2>();  // this thread's copies of tile i have landed
      land(i % NS, tq_.pend[0]);
      __syncthreads();
      const int nxt = tq_.advance(live, nkt);
      if (nxt < nkt) issue((i + NS - 1) % NS, nxt);
      cp_async_commit();
#pragma unroll 1
      for (int sub = 0; sub < NJ / NJS; ++sub) {  // a loop: unrolled, ptxas hoisted the halves into each other and spilled
        float sc[NJS][4];
        s_tile(sc, i % NS, sub * NJS);
        softmax_pv(sc, i % NS, sub * NJS);
      }
      tq_.push(nxt);
    }
    cp_async_wait<0>();
  }

  // ---- epilogue: row sums over the quad, out = acc * (1 / max(l, 1e-30)), padded rows 0
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
  const float f0 = val0 ? 1.f / den0 : 0.f, f1 = val1 ? 1.f / den1 : 0.f;  // one division a row
  float* op0 = out + (((size_t)b * Lq + r0) * H + h) * D + 2 * tq;
  float* op1 = out + (((size_t)b * Lq + r1) * H + h) * D + 2 * tq;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (in0) *reinterpret_cast<float2*>(op0 + 8 * nt) = make_float2(o[nt][0] * f0, o[nt][1] * f0);
    if (in1) *reinterpret_cast<float2*>(op1 + 8 * nt) = make_float2(o[nt][2] * f1, o[nt][3] * f1);
  }
  if (!NOMAX && lse != nullptr && tq == 0) {
    float* lp = lse + ((size_t)b * H + h) * Lq;
    if (in0) lp[r0] = dead ? kNegInf : m0 + log2f(den0);
    if (in1) lp[r1] = dead ? kNegInf : m1 + log2f(den1);
  }
}

// ---------------------------------------------------------------------------
// host side: the bf16 kernel's tensor maps, shared-memory opt-in, launch
// ---------------------------------------------------------------------------
template <int D, bool NOMAX, bool SEG, int NC> static cudaError_t opt_in_smem() {
  return cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D, NOMAX, SEG, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              fwd_smem_bytes<D, NC>());
}

// Every instantiation's shared-memory opt-in, once per process, on the
// first call (which the wrappers make eagerly, never inside a graph capture).
template <int D> static cudaError_t opt_in_head_dim() {
  cudaError_t e = cudaSuccess;
#define SRHEP_OPT_IN(NM, SG)                                                                                \
  if (e == cudaSuccess) e = opt_in_smem<D, NM, SG, 1>();                                                   \
  if (e == cudaSuccess) e = opt_in_smem<D, NM, SG, 3>();                                                   \
  if (e == cudaSuccess)                                                                                    \
    e = cudaFuncSetAttribute(flash_fwd_f32_kernel<D, NM, SG>, cudaFuncAttributeMaxDynamicSharedMemorySize, \
                             kF32MaxSmem);
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
  const cudaError_t opt = opt_in_all();
  if (opt != cudaSuccess) return (int)opt;
  const int smem = FwdF32<D>::smem_bytes((Lk + kF32Tile - 1) / kF32Tile);
  if (smem > kF32MaxSmem) return (int)cudaErrorInvalidValue;
  dim3 grid((Lq + kF32Rows - 1) / kF32Rows, H, B);
  flash_fwd_f32_kernel<D, NOMAX, SEG><<<grid, kThreads, smem, stream>>>(
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
