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
//     get the additive -1e30 bias;
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
// batch row, head and 64-query tile, looping over key tiles; dk/dv: one block
// per batch row, head and 64-key tile, looping over query tiles).  No atomics:
// every output element is written by the one block that owns it, so the
// result is deterministic.  The transposed (B, H, D, L) layout becomes
// (B, L, H, D) views with D contiguous, as in the forward kernel, so the
// unfused path's q/k/v projections arrive without a copy.  The packed band is
// found by each block at its own 64-row tile (common.cuh::segment_band), not
// fed in at 512-wide blocks as on the TPU: exact, so no segment-length cap
// can cut a segment short.
//
// What bounds it on the card: operations (dq: 3 products of 2*D flops per
// live (query, key) pair; dk/dv: 4 products), ~1000 flop per byte moved at
// L = 2048, D = 64 in bf16, far above the H100's ~295.  What the design does
// about it: bf16 runs on the tensor cores (mma.sync.m16n8k16, fp32
// accumulate).  Each warp owns 16 rows; S and dP (16 x 64 per warp) stay in
// registers in the instruction's accumulator layout, which is also the A
// operand layout of the next product, so P and dS never touch shared memory.
// The streamed operand tile (K and V for dq; Q and G for dk/dv) is staged as
// it lies in memory ([row][d], padded rows); a plain ldmatrix gives the B
// fragments of S = A B^T and a transposing one those of acc += P B.
// wgmma, TMA and a multi-stage pipeline are left to a later pass.  The fp32
// build (FMA loops, two threads per row, no tensor cores) exists to hold the
// arithmetic tightly against the plain PyTorch version.  Packed rows: 6*D
// (dq) and 8*D (dk, dv) flops per same-segment pair, sum over events of len^2;
// bound by operations in the same way.
#include "common.cuh"

namespace srhep {

namespace bwd {

constexpr int BR = 64;  // rows per block (queries for dq, keys for dk/dv), bf16 and fp32
constexpr int BT = 64;  // streamed tile (keys for dq, queries for dk/dv), bf16

// A fragments (m16n8k16, rows r0 = 16*warp + g and r1 = r0 + 8 of the block)
// of the warp's 16 rows of a strided (B, L, H, D) operand, straight from
// device memory.  Rows past L read as zeros.
template <int D>
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[D / 16][4], const bf16* __restrict__ base, Strides s,
                                            int b, int h, int r0, int r1, int L, int t) {
  const bf16* p0 = base + (size_t)b * s.b + (size_t)r0 * s.l + (size_t)h * s.h + 2 * t;
  const bf16* p1 = base + (size_t)b * s.b + (size_t)r1 * s.l + (size_t)h * s.h + 2 * t;
#pragma unroll
  for (int st = 0; st < D / 16; ++st) {
    a[st][0] = r0 < L ? *reinterpret_cast<const uint32_t*>(p0 + 16 * st) : 0u;
    a[st][1] = r1 < L ? *reinterpret_cast<const uint32_t*>(p1 + 16 * st) : 0u;
    a[st][2] = r0 < L ? *reinterpret_cast<const uint32_t*>(p0 + 16 * st + 8) : 0u;
    a[st][3] = r1 < L ? *reinterpret_cast<const uint32_t*>(p1 + 16 * st + 8) : 0u;
  }
}

// Stage rows row0 .. row0+BT-1 of a strided (B, L, H, D) operand into shared
// memory as [row][d] (row stride D + 8) with 16-byte loads; rows past L are zeros.
template <int D>
__device__ __forceinline__ void stage_rows(bf16* S, const bf16* __restrict__ base, Strides s, int b, int h,
                                           int row0, int L) {
  constexpr int CPR = D / 8, LDS = D + 8;
  for (int c = threadIdx.x; c < BT * CPR; c += kThreads) {
    const int r = c / CPR, cc = c % CPR;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < L)
      x = *reinterpret_cast<const uint4*>(base + (size_t)b * s.b + (size_t)(row0 + r) * s.l + (size_t)h * s.h + 8 * cc);
    *reinterpret_cast<uint4*>(&S[r * LDS + 8 * cc]) = x;
  }
}

// s (16 x 64 per warp, fp32) = A (the warp's 16 rows, fragments) * S^T, S the
// staged [row][d] tile: S is "n-major", so a plain ldmatrix delivers the B
// fragments of two 8-wide column tiles at once.
template <int D>
__device__ __forceinline__ void rows_times_tile_t(float (&s)[BT / 8][4], const uint32_t (&a)[D / 16][4],
                                                  const bf16* S, int lane) {
  constexpr int LDS = D + 8;
#pragma unroll
  for (int j = 0; j < BT / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int st = 0; st < D / 16; ++st) {
#pragma unroll
    for (int jp = 0; jp < BT / 16; ++jp) {
      uint32_t fb[4];
      ldmatrix_x4(fb, S + 16 * jp * LDS + 16 * st + ldsm_b_offset(lane, LDS));
      const uint32_t b0[2] = {fb[0], fb[1]}, b1[2] = {fb[2], fb[3]};
      mma_bf16_16816(s[2 * jp], a[st], b0);
      mma_bf16_16816(s[2 * jp + 1], a[st], b1);
    }
  }
}

// acc (16 x D per warp) += P (16 x 64, fp32 accumulators, rounded to bf16 here)
// * S, S the staged [row][d] tile read as [k][n]: two adjacent 8-wide
// accumulator tiles of P are the A operand of one k-step, a transposing
// ldmatrix gives the B fragments of two 8-wide slices of D.
template <int D>
__device__ __forceinline__ void acc_p_times_tile(float (&acc)[D / 8][4], const float (&p)[BT / 8][4], const bf16* S,
                                                 int lane) {
  constexpr int LDS = D + 8;
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    pa[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    pa[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    pa[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
    for (int jp = 0; jp < D / 16; ++jp) {
      uint32_t fb[4];
      ldmatrix_x4_trans(fb, S + 16 * kk * LDS + 16 * jp + ldsm_a_offset(lane, LDS));
      const uint32_t b0[2] = {fb[0], fb[1]}, b1[2] = {fb[2], fb[3]};
      mma_bf16_16816(acc[2 * jp], pa, b0);
      mma_bf16_16816(acc[2 * jp + 1], pa, b1);
    }
  }
}

// Write the warp's 16 x D accumulator rows r0, r1 of a contiguous (B, L, H, D) output.
template <int D>
__device__ __forceinline__ void store_rows(bf16* __restrict__ out, const float (&acc)[D / 8][4], int b, int h, int H,
                                           int r0, int r1, int L, int t) {
  bf16* o0 = out + (((size_t)b * L + r0) * H + h) * D;
  bf16* o1 = out + (((size_t)b * L + r1) * H + h) * D;
#pragma unroll
  for (int jd = 0; jd < D / 8; ++jd) {
    if (r0 < L) *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * jd + 2 * t) = __floats2bfloat162_rn(acc[jd][0], acc[jd][1]);
    if (r1 < L) *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * jd + 2 * t) = __floats2bfloat162_rn(acc[jd][2], acc[jd][3]);
  }
}

}  // namespace bwd

// ---------------------------------------------------------------------------
// bf16, K5: dq.  Block = 4 warps = 64 query rows, key tiles of 64.
// lane = 4*g + t: the thread holds rows g and g+8 of its warp's 16, columns
// 2t, 2t+1 of every 8-wide fragment.
// ---------------------------------------------------------------------------
template <int D, bool SEG>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                         const bf16* __restrict__ g, const float* __restrict__ lse, const float* __restrict__ dl,
                         const void* __restrict__ qmask, const void* __restrict__ kmask, bf16* __restrict__ dq,
                         int H, int Lq, int Lk, Strides qs, Strides ks, Strides vs, Strides gs) {
  using namespace bwd;
  constexpr int LDS = D + 8;
  __shared__ __align__(16) bf16 Ks[BT * LDS];
  __shared__ __align__(16) bf16 Vs[BT * LDS];
  __shared__ int kid[BT];  // key ids of the staged tile (common.cuh)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gi = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const int r0 = q0 + 16 * warp + gi, r1 = r0 + 8;
  const bool val0 = r0 < Lq && query_valid<SEG>(qmask, (size_t)b * Lq + r0);
  const bool val1 = r1 < Lq && query_valid<SEG>(qmask, (size_t)b * Lq + r1);
  const int qid0 = r0 < Lq ? query_id<SEG>(qmask, (size_t)b * Lq + r0) : kPadSeg;
  const int qid1 = r1 < Lq ? query_id<SEG>(qmask, (size_t)b * Lq + r1) : kPadSeg;
  const int live_q = __syncthreads_or(val0 || val1);

  float acc[D / 8][4];
#pragma unroll
  for (int jd = 0; jd < D / 8; ++jd) acc[jd][0] = acc[jd][1] = acc[jd][2] = acc[jd][3] = 0.f;

  if (live_q) {  // block-uniform
    uint32_t qa[D / 16][4], ga[D / 16][4];
    load_a_rows<D>(qa, q, qs, b, h, r0, r1, Lq, t);
    load_a_rows<D>(ga, g, gs, b, h, r0, r1, Lq, t);
    const size_t rb = ((size_t)b * H + h) * Lq;
    const float lse0 = r0 < Lq ? lse[rb + r0] : 0.f, lse1 = r1 < Lq ? lse[rb + r1] : 0.f;
    const float dl0 = r0 < Lq ? dl[rb + r0] : 0.f, dl1 = r1 < Lq ? dl[rb + r1] : 0.f;

    const int2 band = SEG ? segment_band<BT>(static_cast<const int*>(kmask) + (size_t)b * Lk, Lk, qid0, val0, qid1,
                                             val1)
                          : make_int2(0, (Lk + BT - 1) / BT - 1);
    for (int kt = band.x; kt <= band.y; ++kt) {
      const int k0 = kt * BT;
      __syncthreads();  // previous tile consumed
      int my_kid = kNoKey;
      if (tid < BT) {
        my_kid = (k0 + tid) < Lk ? key_id<SEG>(kmask, (size_t)b * Lk + k0 + tid) : kNoKey;
        kid[tid] = my_kid;
      }
      if (!__syncthreads_or(my_kid >= 0)) continue;  // no live key in this tile
      stage_rows<D>(Ks, k, ks, b, h, k0, Lk);
      stage_rows<D>(Vs, v, vs, b, h, k0, Lk);
      __syncthreads();

      float s[BT / 8][4], dp[BT / 8][4];
      rows_times_tile_t<D>(s, qa, Ks, lane);   // S  = Q K^T
      rows_times_tile_t<D>(dp, ga, Vs, lane);  // dP = G V^T
#pragma unroll
      for (int j = 0; j < BT / 8; ++j) {
        const int ia = kid[8 * j + 2 * t], ib = kid[8 * j + 2 * t + 1];
        // s becomes dS = P * (dP - dl); masked pairs carry the -1e30 bias
        s[j][0] = exp2f(fminf((s[j][0] + (ia == qid0 ? 0.f : -kBig)) - lse0, 0.f)) * (dp[j][0] - dl0);
        s[j][1] = exp2f(fminf((s[j][1] + (ib == qid0 ? 0.f : -kBig)) - lse0, 0.f)) * (dp[j][1] - dl0);
        s[j][2] = exp2f(fminf((s[j][2] + (ia == qid1 ? 0.f : -kBig)) - lse1, 0.f)) * (dp[j][2] - dl1);
        s[j][3] = exp2f(fminf((s[j][3] + (ib == qid1 ? 0.f : -kBig)) - lse1, 0.f)) * (dp[j][3] - dl1);
      }
      acc_p_times_tile<D>(acc, s, Ks, lane);  // dQ += dS K
    }
  }
  store_rows<D>(dq, acc, b, h, H, r0, r1, Lq, t);
}

// ---------------------------------------------------------------------------
// bf16, K6: dk and dv.  Block = 4 warps = 64 key rows, query tiles of 64;
// the products run transposed (S^T = K Q^T, dP^T = V G^T), so the key rows are
// the A operand held in registers and both outputs accumulate per warp.
// ---------------------------------------------------------------------------
template <int D, bool SEG>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                          const bf16* __restrict__ g, const float* __restrict__ lse, const float* __restrict__ dl,
                          const void* __restrict__ qmask, const void* __restrict__ kmask, bf16* __restrict__ dk,
                          bf16* __restrict__ dv, int H, int Lq, int Lk, Strides qs, Strides ks, Strides vs,
                          Strides gs) {
  using namespace bwd;
  constexpr int LDS = D + 8;
  __shared__ __align__(16) bf16 Qs[BT * LDS];
  __shared__ __align__(16) bf16 Gs[BT * LDS];
  __shared__ float lses[BT], dls[BT];
  __shared__ int qids[BT];  // query ids of the staged tile

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gi = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BR, h = blockIdx.y, b = blockIdx.z;
  const int r0 = k0 + 16 * warp + gi, r1 = r0 + 8;
  const int kid0 = r0 < Lk ? key_id<SEG>(kmask, (size_t)b * Lk + r0) : kNoKey;
  const int kid1 = r1 < Lk ? key_id<SEG>(kmask, (size_t)b * Lk + r1) : kNoKey;
  const int live_k = __syncthreads_or(kid0 >= 0 || kid1 >= 0);

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int jd = 0; jd < D / 8; ++jd) {
    dka[jd][0] = dka[jd][1] = dka[jd][2] = dka[jd][3] = 0.f;
    dva[jd][0] = dva[jd][1] = dva[jd][2] = dva[jd][3] = 0.f;
  }

  if (live_k) {  // block-uniform
    uint32_t ka[D / 16][4], va[D / 16][4];
    load_a_rows<D>(ka, k, ks, b, h, r0, r1, Lk, t);
    load_a_rows<D>(va, v, vs, b, h, r0, r1, Lk, t);
    const size_t rb = ((size_t)b * H + h) * Lq;

    const int2 band = SEG ? segment_band<BT>(static_cast<const int*>(qmask) + (size_t)b * Lq, Lq, kid0, kid0 >= 0,
                                             kid1, kid1 >= 0)
                          : make_int2(0, (Lq + BT - 1) / BT - 1);
    for (int qt = band.x; qt <= band.y; ++qt) {
      const int q0 = qt * BT;
      __syncthreads();  // previous tile consumed
      bool my_valid = false;
      if (tid < BT) {
        const int r = q0 + tid;
        my_valid = r < Lq && query_valid<SEG>(qmask, (size_t)b * Lq + r);
        qids[tid] = r < Lq ? query_id<SEG>(qmask, (size_t)b * Lq + r) : kPadSeg;
        lses[tid] = r < Lq ? lse[rb + r] : 0.f;
        dls[tid] = r < Lq ? dl[rb + r] : 0.f;
      }
      if (!__syncthreads_or(my_valid)) continue;  // no valid query in this tile
      stage_rows<D>(Qs, q, qs, b, h, q0, Lq);
      stage_rows<D>(Gs, g, gs, b, h, q0, Lq);
      __syncthreads();

      float s[BT / 8][4], dp[BT / 8][4];
      rows_times_tile_t<D>(s, ka, Qs, lane);   // S^T  = K Q^T
      rows_times_tile_t<D>(dp, va, Gs, lane);  // dP^T = V G^T
#pragma unroll
      for (int j = 0; j < BT / 8; ++j) {
        const int c = 8 * j + 2 * t;
        const float la = lses[c], lb = lses[c + 1], da = dls[c], db = dls[c + 1];
        const int ia = qids[c], ib = qids[c + 1];
        // s becomes P^T, dp becomes dS^T = P^T * (dP^T - dl); masked pairs carry the -1e30 bias
        s[j][0] = exp2f(fminf((s[j][0] + (ia == kid0 ? 0.f : -kBig)) - la, 0.f));
        s[j][1] = exp2f(fminf((s[j][1] + (ib == kid0 ? 0.f : -kBig)) - lb, 0.f));
        s[j][2] = exp2f(fminf((s[j][2] + (ia == kid1 ? 0.f : -kBig)) - la, 0.f));
        s[j][3] = exp2f(fminf((s[j][3] + (ib == kid1 ? 0.f : -kBig)) - lb, 0.f));
        dp[j][0] = s[j][0] * (dp[j][0] - da);
        dp[j][1] = s[j][1] * (dp[j][1] - db);
        dp[j][2] = s[j][2] * (dp[j][2] - da);
        dp[j][3] = s[j][3] * (dp[j][3] - db);
      }
      acc_p_times_tile<D>(dva, s, Gs, lane);   // dV += P^T G
      acc_p_times_tile<D>(dka, dp, Qs, lane);  // dK += dS^T Q
    }
  }
  store_rows<D>(dk, dka, b, h, H, r0, r1, Lk, t);
  store_rows<D>(dv, dva, b, h, H, r0, r1, Lk, t);
}

// ---------------------------------------------------------------------------
// fp32: two threads per row (each holds half of D; dot products meet through
// one shuffle), 64 rows per block, streamed tiles of 32 rows through shared
// memory (both threads of a row read the same tile row: a broadcast).
// ---------------------------------------------------------------------------
namespace bwd {

constexpr int BT32 = 32;

template <int D>
__device__ __forceinline__ void load_half_row(float (&r)[D / 2], const float* __restrict__ base, Strides s, int b,
                                              int h, int row, bool in_range, int half) {
  const float* p = base + (size_t)b * s.b + (size_t)(in_range ? row : 0) * s.l + (size_t)h * s.h + half * (D / 2);
#pragma unroll
  for (int d = 0; d < D / 2; d += 4) {
    const float4 x = in_range ? *reinterpret_cast<const float4*>(p + d) : make_float4(0.f, 0.f, 0.f, 0.f);
    r[d] = x.x;
    r[d + 1] = x.y;
    r[d + 2] = x.z;
    r[d + 3] = x.w;
  }
}

template <int D>
__device__ __forceinline__ void stage_rows_f32(float* S, const float* __restrict__ base, Strides s, int b, int h,
                                               int row0, int L) {
  constexpr int CPR = D / 4;
  for (int c = threadIdx.x; c < BT32 * CPR; c += kThreads) {
    const int r = c / CPR, cc = c % CPR;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < L)
      x = *reinterpret_cast<const float4*>(base + (size_t)b * s.b + (size_t)(row0 + r) * s.l + (size_t)h * s.h + 4 * cc);
    *reinterpret_cast<float4*>(&S[r * D + 4 * cc]) = x;
  }
}

// dot product of a register half-row with half a shared-memory row, summed
// over the two threads of the row
template <int D>
__device__ __forceinline__ float dot_pair(const float (&r)[D / 2], const float* srow) {
  float a = 0.f;
#pragma unroll
  for (int d = 0; d < D / 2; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(srow + d);
    a = fmaf(r[d], x.x, a);
    a = fmaf(r[d + 1], x.y, a);
    a = fmaf(r[d + 2], x.z, a);
    a = fmaf(r[d + 3], x.w, a);
  }
  return a + __shfl_xor_sync(0xffffffffu, a, 1);
}

template <int D>
__device__ __forceinline__ void axpy_half(float (&acc)[D / 2], float a, const float* srow) {
#pragma unroll
  for (int d = 0; d < D / 2; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(srow + d);
    acc[d] = fmaf(a, x.x, acc[d]);
    acc[d + 1] = fmaf(a, x.y, acc[d + 1]);
    acc[d + 2] = fmaf(a, x.z, acc[d + 2]);
    acc[d + 3] = fmaf(a, x.w, acc[d + 3]);
  }
}

template <int D>
__device__ __forceinline__ void store_half_row(float* __restrict__ out, const float (&acc)[D / 2], int b, int h,
                                               int H, int row, int L, int half) {
  if (row >= L) return;
  float* p = out + (((size_t)b * L + row) * H + h) * D + half * (D / 2);
#pragma unroll
  for (int d = 0; d < D / 2; d += 4)
    *reinterpret_cast<float4*>(p + d) = make_float4(acc[d], acc[d + 1], acc[d + 2], acc[d + 3]);
}

}  // namespace bwd

template <int D, bool SEG>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                        const float* __restrict__ g, const float* __restrict__ lse, const float* __restrict__ dl,
                        const void* __restrict__ qmask, const void* __restrict__ kmask, float* __restrict__ dq,
                        int H, int Lq, int Lk, Strides qs, Strides ks, Strides vs, Strides gs) {
  using namespace bwd;
  constexpr int HD = D / 2;
  __shared__ __align__(16) float Ks[BT32 * D];
  __shared__ __align__(16) float Vs[BT32 * D];
  __shared__ int kid[BT32];

  const int tid = threadIdx.x, half = tid & 1;
  const int row = blockIdx.x * BR + (tid >> 1), h = blockIdx.y, b = blockIdx.z;
  const bool in_range = row < Lq;
  const bool my_valid = in_range && query_valid<SEG>(qmask, (size_t)b * Lq + row);
  const int my_qid = in_range ? query_id<SEG>(qmask, (size_t)b * Lq + row) : kPadSeg;
  const int live_q = __syncthreads_or(my_valid);

  float acc[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;

  if (live_q) {
    float qr[HD], gr[HD];
    load_half_row<D>(qr, q, qs, b, h, row, in_range, half);
    load_half_row<D>(gr, g, gs, b, h, row, in_range, half);
    const size_t rb = ((size_t)b * H + h) * Lq;
    const float lse_r = in_range ? lse[rb + row] : 0.f, dl_r = in_range ? dl[rb + row] : 0.f;

    const int2 band = SEG ? segment_band<BT32>(static_cast<const int*>(kmask) + (size_t)b * Lk, Lk, my_qid, my_valid,
                                               0, false)
                          : make_int2(0, (Lk + BT32 - 1) / BT32 - 1);
    for (int kt = band.x; kt <= band.y; ++kt) {
      const int k0 = kt * BT32;
      __syncthreads();
      int my_kid = kNoKey;
      if (tid < BT32) {
        my_kid = (k0 + tid) < Lk ? key_id<SEG>(kmask, (size_t)b * Lk + k0 + tid) : kNoKey;
        kid[tid] = my_kid;
      }
      if (!__syncthreads_or(my_kid >= 0)) continue;
      stage_rows_f32<D>(Ks, k, ks, b, h, k0, Lk);
      stage_rows_f32<D>(Vs, v, vs, b, h, k0, Lk);
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < BT32; ++j) {
        const float* kj = &Ks[j * D + half * HD];
        const float s = dot_pair<D>(qr, kj);
        const float dp = dot_pair<D>(gr, &Vs[j * D + half * HD]);
        const float p = exp2f(fminf((s + (kid[j] == my_qid ? 0.f : -kBig)) - lse_r, 0.f));
        axpy_half<D>(acc, p * (dp - dl_r), kj);
      }
    }
  }
  store_half_row<D>(dq, acc, b, h, H, row, Lq, half);
}

template <int D, bool SEG>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                         const float* __restrict__ g, const float* __restrict__ lse, const float* __restrict__ dl,
                         const void* __restrict__ qmask, const void* __restrict__ kmask, float* __restrict__ dk,
                         float* __restrict__ dv, int H, int Lq, int Lk, Strides qs, Strides ks, Strides vs,
                         Strides gs) {
  using namespace bwd;
  constexpr int HD = D / 2;
  __shared__ __align__(16) float Qs[BT32 * D];
  __shared__ __align__(16) float Gs[BT32 * D];
  __shared__ float lses[BT32], dls[BT32];
  __shared__ int qids[BT32];

  const int tid = threadIdx.x, half = tid & 1;
  const int row = blockIdx.x * BR + (tid >> 1), h = blockIdx.y, b = blockIdx.z;
  const bool in_range = row < Lk;
  const int my_kid = in_range ? key_id<SEG>(kmask, (size_t)b * Lk + row) : kNoKey;
  const int live_k = __syncthreads_or(my_kid >= 0);

  float dka[HD], dva[HD];
#pragma unroll
  for (int d = 0; d < HD; ++d) dka[d] = dva[d] = 0.f;

  if (live_k) {
    float kr[HD], vr[HD];
    load_half_row<D>(kr, k, ks, b, h, row, in_range, half);
    load_half_row<D>(vr, v, vs, b, h, row, in_range, half);
    const size_t rb = ((size_t)b * H + h) * Lq;

    const int2 band = SEG ? segment_band<BT32>(static_cast<const int*>(qmask) + (size_t)b * Lq, Lq, my_kid,
                                               my_kid >= 0, 0, false)
                          : make_int2(0, (Lq + BT32 - 1) / BT32 - 1);
    for (int qt = band.x; qt <= band.y; ++qt) {
      const int q0 = qt * BT32;
      __syncthreads();
      bool my_valid = false;
      if (tid < BT32) {
        const int r = q0 + tid;
        my_valid = r < Lq && query_valid<SEG>(qmask, (size_t)b * Lq + r);
        qids[tid] = r < Lq ? query_id<SEG>(qmask, (size_t)b * Lq + r) : kPadSeg;
        lses[tid] = r < Lq ? lse[rb + r] : 0.f;
        dls[tid] = r < Lq ? dl[rb + r] : 0.f;
      }
      if (!__syncthreads_or(my_valid)) continue;
      stage_rows_f32<D>(Qs, q, qs, b, h, q0, Lq);
      stage_rows_f32<D>(Gs, g, gs, b, h, q0, Lq);
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < BT32; ++i) {
        const float* qi = &Qs[i * D + half * HD];
        const float* gi = &Gs[i * D + half * HD];
        const float s = dot_pair<D>(kr, qi);
        const float dp = dot_pair<D>(vr, gi);
        const float p = exp2f(fminf((s + (qids[i] == my_kid ? 0.f : -kBig)) - lses[i], 0.f));
        axpy_half<D>(dva, p, gi);
        axpy_half<D>(dka, p * (dp - dls[i]), qi);
      }
    }
  }
  store_half_row<D>(dk, dka, b, h, H, row, Lk, half);
  store_half_row<D>(dv, dva, b, h, H, row, Lk, half);
}

template <int D, bool SEG>
static int launch_dq(const void* q, const void* k, const void* v, const void* g, const void* lse, const void* dl,
                     const void* qmask, const void* kmask, void* dq, int B, int H, int Lq, int Lk, Strides qs,
                     Strides ks, Strides vs, Strides gs, int is_bf16, cudaStream_t stream) {
  const dim3 grid((Lq + bwd::BR - 1) / bwd::BR, H, B);
  if (is_bf16)
    flash_bwd_dq_bf16_kernel<D, SEG><<<grid, kThreads, 0, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(g), static_cast<const float*>(lse), static_cast<const float*>(dl), qmask, kmask,
        static_cast<bf16*>(dq), H, Lq, Lk, qs, ks, vs, gs);
  else
    flash_bwd_dq_f32_kernel<D, SEG><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(g), static_cast<const float*>(lse), static_cast<const float*>(dl), qmask, kmask,
        static_cast<float*>(dq), H, Lq, Lk, qs, ks, vs, gs);
  return (int)cudaGetLastError();
}

template <int D, bool SEG>
static int launch_dkv(const void* q, const void* k, const void* v, const void* g, const void* lse, const void* dl,
                      const void* qmask, const void* kmask, void* dk, void* dv, int B, int H, int Lq, int Lk,
                      Strides qs, Strides ks, Strides vs, Strides gs, int is_bf16, cudaStream_t stream) {
  const dim3 grid((Lk + bwd::BR - 1) / bwd::BR, H, B);
  if (is_bf16)
    flash_bwd_dkv_bf16_kernel<D, SEG><<<grid, kThreads, 0, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<const bf16*>(g), static_cast<const float*>(lse), static_cast<const float*>(dl), qmask, kmask,
        static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Lq, Lk, qs, ks, vs, gs);
  else
    flash_bwd_dkv_f32_kernel<D, SEG><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(g), static_cast<const float*>(lse), static_cast<const float*>(dl), qmask, kmask,
        static_cast<float*>(dk), static_cast<float*>(dv), H, Lq, Lk, qs, ks, vs, gs);
  return (int)cudaGetLastError();
}

}  // namespace srhep

// q (B, Lq, H, D), k, v (B, Lk, H, D), g (B, Lq, H, D) as strided views with D
// contiguous (strides in elements, 16-byte aligned); lse, dl (B, H, Lq) fp32;
// qm (B, Lq), km (B, Lk) fp32; dq (B, Lq, H, D) contiguous, in q's dtype,
// WITHOUT the ln(2) factor.  D in {16, 32, 64}.  Returns cudaGetLastError().
extern "C" int srhep_flash_bwd_dq(const void* q, const void* k, const void* v, const void* g, const void* lse,
                                  const void* dl, const void* qm, const void* km, void* dq, int B, int H, int Lq,
                                  int Lk, int D, long long qsb, long long qsl, long long qsh, long long ksb,
                                  long long ksl, long long ksh, long long vsb, long long vsl, long long vsh,
                                  long long gsb, long long gsl, long long gsh, int is_bf16, void* stream) {
  using namespace srhep;
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qsl, qsh}, ks{ksb, ksl, ksh}, vs{vsb, vsl, vsh}, gs{gsb, gsl, gsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_dq<16, false>(q, k, v, g, lse, dl, qm, km, dq, B, H, Lq, Lk, qs, ks, vs, gs, is_bf16, s);
    case 32: return launch_dq<32, false>(q, k, v, g, lse, dl, qm, km, dq, B, H, Lq, Lk, qs, ks, vs, gs, is_bf16, s);
    case 64: return launch_dq<64, false>(q, k, v, g, lse, dl, qm, km, dq, B, H, Lq, Lk, qs, ks, vs, gs, is_bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Same operands; dk, dv (B, Lk, H, D) contiguous in k's / v's dtype, dk
// WITHOUT the ln(2) factor.  Returns cudaGetLastError().
extern "C" int srhep_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* g, const void* lse,
                                   const void* dl, const void* qm, const void* km, void* dk, void* dv, int B, int H,
                                   int Lq, int Lk, int D, long long qsb, long long qsl, long long qsh, long long ksb,
                                   long long ksl, long long ksh, long long vsb, long long vsl, long long vsh,
                                   long long gsb, long long gsl, long long gsh, int is_bf16, void* stream) {
  using namespace srhep;
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qsl, qsh}, ks{ksb, ksl, ksh}, vs{vsb, vsl, vsh}, gs{gsb, gsl, gsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_dkv<16, false>(q, k, v, g, lse, dl, qm, km, dk, dv, B, H, Lq, Lk, qs, ks, vs, gs, is_bf16, s);
    case 32: return launch_dkv<32, false>(q, k, v, g, lse, dl, qm, km, dk, dv, B, H, Lq, Lk, qs, ks, vs, gs, is_bf16, s);
    case 64: return launch_dkv<64, false>(q, k, v, g, lse, dl, qm, km, dk, dv, B, H, Lq, Lk, qs, ks, vs, gs, is_bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Segment-packed rows (K8): q, k, v, g (B, S, H, D) as strided views with D
// contiguous, g zeroed on padding; lse, dl (B, H, S) fp32; seg (B, S) int32,
// -1 on padding, valid ids nondecreasing along each row; dq (B, S, H, D)
// contiguous, WITHOUT the ln(2) factor.  D in {16, 32, 64}.
extern "C" int srhep_packed_bwd_dq(const void* q, const void* k, const void* v, const void* g, const void* lse,
                                   const void* dl, const void* seg, void* dq, int B, int H, int S, int D, long long qsb,
                                   long long qsl, long long qsh, long long ksb, long long ksl, long long ksh,
                                   long long vsb, long long vsl, long long vsh, long long gsb, long long gsl,
                                   long long gsh, int is_bf16, void* stream) {
  using namespace srhep;
  if (B <= 0 || H <= 0 || S <= 0 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qsl, qsh}, ks{ksb, ksl, ksh}, vs{vsb, vsl, vsh}, gs{gsb, gsl, gsh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_dq<16, true>(q, k, v, g, lse, dl, seg, seg, dq, B, H, S, S, qs, ks, vs, gs, is_bf16, st);
    case 32: return launch_dq<32, true>(q, k, v, g, lse, dl, seg, seg, dq, B, H, S, S, qs, ks, vs, gs, is_bf16, st);
    case 64: return launch_dq<64, true>(q, k, v, g, lse, dl, seg, seg, dq, B, H, S, S, qs, ks, vs, gs, is_bf16, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Segment-packed rows (K9): the same operands; dk, dv (B, S, H, D) contiguous,
// dk WITHOUT the ln(2) factor.
extern "C" int srhep_packed_bwd_dkv(const void* q, const void* k, const void* v, const void* g, const void* lse,
                                    const void* dl, const void* seg, void* dk, void* dv, int B, int H, int S, int D,
                                    long long qsb, long long qsl, long long qsh, long long ksb, long long ksl,
                                    long long ksh, long long vsb, long long vsl, long long vsh, long long gsb,
                                    long long gsl, long long gsh, int is_bf16, void* stream) {
  using namespace srhep;
  if (B <= 0 || H <= 0 || S <= 0 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qsl, qsh}, ks{ksb, ksl, ksh}, vs{vsb, vsl, vsh}, gs{gsb, gsl, gsh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_dkv<16, true>(q, k, v, g, lse, dl, seg, seg, dk, dv, B, H, S, S, qs, ks, vs, gs, is_bf16, st);
    case 32: return launch_dkv<32, true>(q, k, v, g, lse, dl, seg, seg, dk, dv, B, H, S, S, qs, ks, vs, gs, is_bf16, st);
    case 64: return launch_dkv<64, true>(q, k, v, g, lse, dl, seg, seg, dk, dv, B, H, S, S, qs, ks, vs, gs, is_bf16, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
