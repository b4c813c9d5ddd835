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
// head and 64-query tile; m, l and the output accumulator live in registers);
// the transposed (B, H, D, L) layout, which existed to fill a 128-lane matrix
// unit, becomes (B, L, H, D) views with D contiguous and free strides for B, L
// and H, so K/V tiles arrive with coalesced 16-byte loads straight out of the
// fused projection's (B, L, 3F) buffer.  The packed kernel's band, which the
// TPU computed outside the kernel at 512-wide blocks and fed by scalar
// prefetch, is found by each block itself at its 64-query tile
// (common.cuh::segment_band): tighter, and exact, so no segment-length cap
// can cut a segment short.
//
// What bounds it on the card: operations.  4*L*L*D flops per (b, h) against
// 4*L*D elements moved: at L = 2048, D = 64 that is ~1000 flop/byte in bf16,
// far above the H100's ~295.  What the design does about it: bf16 runs on the
// tensor cores (mma.sync.m16n8k16, fp32 accumulate) with S, P and O kept in
// registers in the instruction's fragment layout, so P goes from the S
// accumulators into the PV product's A operand without touching shared memory;
// K and V are staged as they lie in memory ([key][d], padded rows) and one
// conflict-free ldmatrix (transposing, for V) delivers the B fragments of two
// 8-wide tiles.  wgmma, TMA and a multi-stage pipeline are left to a later
// pass.  The fp32 build (one thread per query row, FMA loops) exists to hold
// the arithmetic tightly against the plain PyTorch version; it uses no tensor
// cores.  Packed rows are bound the same way: 4*D flops per same-segment
// (query, key) pair, sum over events of len^2, against one read of q, k, v
// and one write of out; the band costs one extra pass over the row's int32
// segment ids per block (20 KB at S = 5120, from L2).
#include "common.cuh"

namespace srhep {

constexpr float kClipLo = -126.0f;
constexpr float kClipHi = 80.0f;

// ---------------------------------------------------------------------------
// bf16: tensor cores.  Block = 4 warps = 64 query rows (16 per warp), key
// tiles of 64.  lane = 4*g + t: the thread holds rows g and g+8 of its warp's
// 16, columns 2t, 2t+1 of every 8-wide fragment.
// ---------------------------------------------------------------------------
template <int D, bool NOMAX, bool SEG>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                      const void* __restrict__ qmask, const void* __restrict__ kmask, bf16* __restrict__ out,
                      float* __restrict__ lse, int H, int Lq, int Lk, Strides qs, Strides ks, Strides vs) {
  constexpr int BQ = 64, BK = 64;
  constexpr int LDK = D + 8;    // row stride of Ks and Vs (elements)
  constexpr int KSTEPS = D / 16;  // k-steps of the QK^T product
  constexpr int DT = D / 8;       // 8-wide output fragments over D
  __shared__ __align__(16) bf16 Ks[BK * LDK];  // [key][d]
  __shared__ __align__(16) bf16 Vs[BK * LDK];  // [key][d]
  __shared__ int kid[BK];                      // key ids of the staged tile (common.cuh)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int r0 = q0 + 16 * warp + g, r1 = r0 + 8;

  const bool val0 = r0 < Lq && query_valid<SEG>(qmask, (size_t)b * Lq + r0);
  const bool val1 = r1 < Lq && query_valid<SEG>(qmask, (size_t)b * Lq + r1);
  const int qid0 = r0 < Lq ? query_id<SEG>(qmask, (size_t)b * Lq + r0) : kPadSeg;
  const int qid1 = r1 < Lq ? query_id<SEG>(qmask, (size_t)b * Lq + r1) : kPadSeg;
  const int tile_has_query = __syncthreads_or(val0 || val1);

  bf16* o0p = out + (((size_t)b * Lq + r0) * H + h) * D;
  bf16* o1p = out + (((size_t)b * Lq + r1) * H + h) * D;

  if (!tile_has_query) {  // block-uniform: nothing to attend from
#pragma unroll
    for (int jd = 0; jd < DT; ++jd) {
      const __nv_bfloat162 z = __floats2bfloat162_rn(0.f, 0.f);
      if (r0 < Lq) *reinterpret_cast<__nv_bfloat162*>(o0p + 8 * jd + 2 * t) = z;
      if (r1 < Lq) *reinterpret_cast<__nv_bfloat162*>(o1p + 8 * jd + 2 * t) = z;
    }
    if (lse != nullptr && t == 0) {
      if (r0 < Lq) lse[((size_t)b * H + h) * Lq + r0] = kNegInf;
      if (r1 < Lq) lse[((size_t)b * H + h) * Lq + r1] = kNegInf;
    }
    return;
  }

  // Q fragments straight from device memory (read once per block)
  uint32_t qa[KSTEPS][4];
  {
    const bf16* q0p = q + (size_t)b * qs.b + (size_t)r0 * qs.l + (size_t)h * qs.h + 2 * t;
    const bf16* q1p = q + (size_t)b * qs.b + (size_t)r1 * qs.l + (size_t)h * qs.h + 2 * t;
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) {
      qa[s][0] = r0 < Lq ? *reinterpret_cast<const uint32_t*>(q0p + 16 * s) : 0u;
      qa[s][1] = r1 < Lq ? *reinterpret_cast<const uint32_t*>(q1p + 16 * s) : 0u;
      qa[s][2] = r0 < Lq ? *reinterpret_cast<const uint32_t*>(q0p + 16 * s + 8) : 0u;
      qa[s][3] = r1 < Lq ? *reinterpret_cast<const uint32_t*>(q1p + 16 * s + 8) : 0u;
    }
  }

  float o[DT][4];
#pragma unroll
  for (int jd = 0; jd < DT; ++jd) o[jd][0] = o[jd][1] = o[jd][2] = o[jd][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // running max of rows r0, r1 (robust only)
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sums

  // key tiles to visit: all of them, or the packed row's band
  const int2 band = SEG ? segment_band<BK>(static_cast<const int*>(kmask) + (size_t)b * Lk, Lk, qid0, val0, qid1, val1)
                        : make_int2(0, (Lk + BK - 1) / BK - 1);
  for (int kt = band.x; kt <= band.y; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // previous tile consumed
    int my_kid = kNoKey;
    if (tid < BK) {
      my_kid = (k0 + tid) < Lk ? key_id<SEG>(kmask, (size_t)b * Lk + k0 + tid) : kNoKey;
      kid[tid] = my_kid;
    }
    if (!__syncthreads_or(my_kid >= 0)) continue;  // no live key in this tile

    // stage K and V, both [key][d], with 16-byte loads
    constexpr int CPR = D / 8;
    for (int c = tid; c < BK * CPR; c += kThreads) {
      const int r = c / CPR, cc = c % CPR;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + r < Lk) {
        kv = *reinterpret_cast<const uint4*>(k + (size_t)b * ks.b + (size_t)(k0 + r) * ks.l + (size_t)h * ks.h + 8 * cc);
        vv = *reinterpret_cast<const uint4*>(v + (size_t)b * vs.b + (size_t)(k0 + r) * vs.l + (size_t)h * vs.h + 8 * cc);
      }
      *reinterpret_cast<uint4*>(&Ks[r * LDK + 8 * cc]) = kv;
      *reinterpret_cast<uint4*>(&Vs[r * LDK + 8 * cc]) = vv;
    }
    __syncthreads();

    // S = Q K^T  (16 x 64 per warp, fp32)
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int st = 0; st < KSTEPS; ++st) {
#pragma unroll
      for (int jp = 0; jp < BK / 16; ++jp) {  // two 8-key tiles per ldmatrix
        uint32_t kb[4];
        ldmatrix_x4(kb, &Ks[16 * jp * LDK + 16 * st] + ldsm_b_offset(lane, LDK));
        const uint32_t b0[2] = {kb[0], kb[1]}, b1[2] = {kb[2], kb[3]};
        mma_bf16_16816(s[2 * jp], qa[st], b0);
        mma_bf16_16816(s[2 * jp + 1], qa[st], b1);
      }
    }

    // softmax numerators in place: s becomes p
    float ps0 = 0.f, ps1 = 0.f;
    if (NOMAX) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const int ia = kid[8 * j + 2 * t], ib = kid[8 * j + 2 * t + 1];
        s[j][0] = exp2f(fminf(fmaxf(s[j][0], kClipLo), kClipHi)) * (ia == qid0 ? 1.f : 0.f);
        s[j][1] = exp2f(fminf(fmaxf(s[j][1], kClipLo), kClipHi)) * (ib == qid0 ? 1.f : 0.f);
        s[j][2] = exp2f(fminf(fmaxf(s[j][2], kClipLo), kClipHi)) * (ia == qid1 ? 1.f : 0.f);
        s[j][3] = exp2f(fminf(fmaxf(s[j][3], kClipLo), kClipHi)) * (ib == qid1 ? 1.f : 0.f);
        ps0 += s[j][0] + s[j][1];
        ps1 += s[j][2] + s[j][3];
      }
      l0 += ps0;
      l1 += ps1;
    } else {
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        // additive bias of a masked pair: (eq - 1) * 1e30, as the TPU kernels
        const int ia = kid[8 * j + 2 * t], ib = kid[8 * j + 2 * t + 1];
        s[j][0] += ia == qid0 ? 0.f : -kBig;
        s[j][1] += ib == qid0 ? 0.f : -kBig;
        s[j][2] += ia == qid1 ? 0.f : -kBig;
        s[j][3] += ib == qid1 ? 0.f : -kBig;
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        s[j][0] = exp2f(s[j][0] - mn0);
        s[j][1] = exp2f(s[j][1] - mn0);
        s[j][2] = exp2f(s[j][2] - mn1);
        s[j][3] = exp2f(s[j][3] - mn1);
        ps0 += s[j][0] + s[j][1];
        ps1 += s[j][2] + s[j][3];
      }
      l0 = l0 * al0 + ps0;
      l1 = l1 * al1 + ps1;
#pragma unroll
      for (int jd = 0; jd < DT; ++jd) {
        o[jd][0] *= al0;
        o[jd][1] *= al0;
        o[jd][2] *= al1;
        o[jd][3] *= al1;
      }
      m0 = mn0;
      m1 = mn1;
    }

    // O += P V: two adjacent 8-wide S fragments are the A operand of one k-step
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int jp = 0; jp < DT / 2; ++jp) {  // two 8-wide slices of D per (transposing) ldmatrix
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, &Vs[16 * kk * LDK + 16 * jp] + ldsm_a_offset(lane, LDK));
        const uint32_t b0[2] = {vb[0], vb[1]}, b1[2] = {vb[2], vb[3]};
        mma_bf16_16816(o[2 * jp], pa, b0);
        mma_bf16_16816(o[2 * jp + 1], pa, b1);
      }
    }
  }

  // row sums across the 4 threads that share a row
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const float f0 = val0 ? 1.f : 0.f, f1 = val1 ? 1.f : 0.f;
#pragma unroll
  for (int jd = 0; jd < DT; ++jd) {
    if (r0 < Lq)
      *reinterpret_cast<__nv_bfloat162*>(o0p + 8 * jd + 2 * t) =
          __floats2bfloat162_rn(o[jd][0] / d0 * f0, o[jd][1] / d0 * f0);
    if (r1 < Lq)
      *reinterpret_cast<__nv_bfloat162*>(o1p + 8 * jd + 2 * t) =
          __floats2bfloat162_rn(o[jd][2] / d1 * f1, o[jd][3] / d1 * f1);
  }
  if (!NOMAX && lse != nullptr && t == 0) {
    if (r0 < Lq) lse[((size_t)b * H + h) * Lq + r0] = m0 + log2f(d0);
    if (r1 < Lq) lse[((size_t)b * H + h) * Lq + r1] = m1 + log2f(d1);
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

template <int D, bool NOMAX, bool SEG>
static int launch_flash(const void* q, const void* k, const void* v, const void* qmask, const void* kmask,
                        void* out, void* lse, int B, int H, int Lq, int Lk, Strides qs, Strides ks, Strides vs,
                        int is_bf16, cudaStream_t stream) {
  if (is_bf16) {
    dim3 grid((Lq + 63) / 64, H, B);
    flash_fwd_bf16_kernel<D, NOMAX, SEG><<<grid, kThreads, 0, stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), qmask, kmask,
        static_cast<bf16*>(out), static_cast<float*>(lse), H, Lq, Lk, qs, ks, vs);
  } else {
    dim3 grid((Lq + kThreads - 1) / kThreads, H, B);
    flash_fwd_f32_kernel<D, NOMAX, SEG><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v), qmask, kmask,
        static_cast<float*>(out), static_cast<float*>(lse), H, Lq, Lk, qs, ks, vs);
  }
  return (int)cudaGetLastError();
}

}  // namespace srhep

// q (B, Lq, H, D), k, v (B, Lk, H, D) as strided views with D contiguous
// (strides in elements, 16-byte aligned); qm (B, Lq), km (B, Lk) fp32;
// out (B, Lq, H, D) contiguous; lse (B, H, Lq) fp32 or null.  D in {16, 32, 64}.
// Returns cudaGetLastError().
extern "C" int srhep_flash_fwd(const void* q, const void* k, const void* v, const void* qm, const void* km,
                               void* out, void* lse, int B, int H, int Lq, int Lk, int D, long long qsb,
                               long long qsl, long long qsh, long long ksb, long long ksl, long long ksh,
                               long long vsb, long long vsl, long long vsh, int is_bf16, int nomax, void* stream) {
  using namespace srhep;
  if (B <= 0 || H <= 0 || Lq <= 0 || Lk <= 0 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  if (nomax && lse != nullptr) return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qsl, qsh}, ks{ksb, ksl, ksh}, vs{vsb, vsl, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SRHEP_FLASH_CASE(DD)                                                                               \
  case DD:                                                                                                 \
    return nomax ? launch_flash<DD, true, false>(q, k, v, qm, km, out, lse, B, H, Lq, Lk, qs, ks, vs, is_bf16, s) \
                 : launch_flash<DD, false, false>(q, k, v, qm, km, out, lse, B, H, Lq, Lk, qs, ks, vs, is_bf16, s);
  switch (D) {
    SRHEP_FLASH_CASE(16)
    SRHEP_FLASH_CASE(32)
    SRHEP_FLASH_CASE(64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SRHEP_FLASH_CASE
}

// Segment-packed rows (K7): q, k, v (B, S, H, D) as strided views with D
// contiguous (strides in elements, 16-byte aligned); seg (B, S) int32, -1 on
// padding, valid ids nondecreasing along each row; out (B, S, H, D)
// contiguous, zero on padding; lse (B, H, S) fp32 or null (robust only).
// D in {16, 32, 64}.  Returns cudaGetLastError().
extern "C" int srhep_packed_fwd(const void* q, const void* k, const void* v, const void* seg, void* out, void* lse,
                                int B, int H, int S, int D, long long qsb, long long qsl, long long qsh,
                                long long ksb, long long ksl, long long ksh, long long vsb, long long vsl,
                                long long vsh, int is_bf16, int nomax, void* stream) {
  using namespace srhep;
  if (B <= 0 || H <= 0 || S <= 0 || B > 65535 || H > 65535) return (int)cudaErrorInvalidValue;
  if (nomax && lse != nullptr) return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qsl, qsh}, ks{ksb, ksl, ksh}, vs{vsb, vsl, vsh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SRHEP_PACKED_CASE(DD)                                                                                \
  case DD:                                                                                                   \
    return nomax ? launch_flash<DD, true, true>(q, k, v, seg, seg, out, lse, B, H, S, S, qs, ks, vs, is_bf16, st) \
                 : launch_flash<DD, false, true>(q, k, v, seg, seg, out, lse, B, H, S, S, qs, ks, vs, is_bf16, st);
  switch (D) {
    SRHEP_PACKED_CASE(16)
    SRHEP_PACKED_CASE(32)
    SRHEP_PACKED_CASE(64)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SRHEP_PACKED_CASE
}
