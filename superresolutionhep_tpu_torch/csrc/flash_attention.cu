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
// The fp32 build (one thread per query row, FMA loops) exists to hold the
// arithmetic tightly against the plain PyTorch version; it uses no tensor
// cores and finds its packed band itself (common.cuh::segment_band).
#include "flash_fwd.cuh"

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
