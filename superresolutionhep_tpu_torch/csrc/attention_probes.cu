// Attention-forward probes for Hopper (sm_90a): the kernels of the two
// measuring scripts, which take attention apart to see what each of its parts
// costs on the card.
//
// Replaces the TPU kernels
//   * scripts/kernel_experiments.py::variant_kernel (through run_variant, K10):
//     unmasked attention forward in four modes (MODE below);
//   * scripts/probe_exp_dtype.py::kernel (through bench, K11): the running-max
//     forward with an additive key mask (km - 1) * 1e30, exp in bf16 or f32
//     (MASK = true with MODE kFull or kFp32Exp).
// What they compute is kept, operation for operation (ops/attention_probes.py
// holds the plain version):
//   * s = q k^T in fp32 on the RAW q (no scale, no base-2 fold): the logits go
//     straight into exp2;
//   * kMatmulsOnly: acc += bf16(s) v; l stays 0, so out = acc / 1e-30;
//   * kNoMax:       p = exp2(bf16(s)) computed in bf16; l += sum(p); acc += p v;
//   * kFull:        online softmax with a running max, p = exp2(bf16(s - m))
//                   computed in bf16, alpha = exp2(m_prev - m) in fp32;
//   * kFp32Exp:     the same with p = exp2(s - m) in fp32, cast to bf16 for PV;
//   * out = bf16(acc / max(l, 1e-30)).
// A key block that is fully masked while m is still -1e30 gives p = 1 for its
// keys (s - m = 0); alpha = 0 wipes them out once a valid block arrives, and a
// row without any valid key comes out as the mean of v.  That is the TPU
// kernel's behaviour and this kernel's too (no tile is skipped).
//
// The exp dtype is real, since the probes exist to measure it: the bf16 modes
// run ex2.approx.ftz.bf16x2 (two bf16 exponentials per instruction on the
// special-function unit), the f32 mode exp2f (ex2.approx.f32).  At D = 64 the
// exp count B*H*L^2 = 2.7e8 at (8, 8, 2048) is about as costly on the SFU as
// the products are on the tensor cores: NVIDIA's table of arithmetic
// instruction throughput gives 16 f32 exp2 results per clock per SM for
// compute capability 9.0 (2.7e8 / (16 * 132 SMs * 1.98 GHz) = 0.064 ms against
// 4*B*H*L^2*D / 989 TFLOP/s = 0.070 ms); the bf16x2 form halves the
// instruction count (0.032 ms if it issues at the f32 rate, which is assumed,
// not documented).  chip_smoke.py prints both bounds beside the times.
//
// What is not carried over: the TPU grid's sequential key axis with its m, l,
// acc scratch becomes a loop over key tiles inside the block, with m, l and
// the output accumulator in registers; the TPU's block sweep (BQ, BK up to
// 2048, with VMEM overflow as the skipped case) becomes a sweep over the tile
// shapes instantiated here: WARPS x 16 query rows (64 or 128) times BK keys
// (64 or 128).  Layout: q, k, v, out (B, H, L, D) contiguous, as the scripts
// hold them; D = 64.
//
// What bounds it on the card: operations, 4*B*H*L^2*D against one read of q,
// k, v and one write of out (~1000 flop/byte at L = 2048), and, as said, the
// exponentials.  The design is K1's (flash_attention.cu): 16 query rows per
// warp on mma.sync.m16n8k16 with fp32 accumulation, S and P in registers in
// the fragment layout, K and V staged [key][d] with a conflict-free (and, for
// V, transposing) ldmatrix.  wgmma and TMA are later work.
#include "common.cuh"

namespace srhep {

constexpr int kProbeD = 64;
enum ProbeMode { kMatmulsOnly = 0, kNoMax = 1, kFull = 2, kFp32Exp = 3 };

// Two bf16 exponentials base 2 in one special-function instruction.
__device__ __forceinline__ uint32_t ex2_bf16x2(uint32_t x) {
  uint32_t y;
  asm("ex2.approx.ftz.bf16x2 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x));
}

// One block = WARPS warps = 16 * WARPS query rows of one (b, h); key tiles of
// BK.  lane = 4*g + t: the thread holds rows g and g+8 of its warp's 16,
// columns 2t, 2t+1 of every 8-wide fragment.
template <int MODE, bool MASK, int WARPS, int BK>
__global__ void __launch_bounds__(32 * WARPS)
probe_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                 const float* __restrict__ km, bf16* __restrict__ out, int H, int L) {
  constexpr int D = kProbeD;
  constexpr int NT = 32 * WARPS;
  constexpr int BQ = 16 * WARPS;
  constexpr int LDK = D + 8;      // row stride of Ks and Vs (elements)
  constexpr int KSTEPS = D / 16;  // k-steps of the QK^T product
  constexpr int DT = D / 8;       // 8-wide output fragments over D
  constexpr int NJ = BK / 8;      // 8-wide key fragments of a tile
  __shared__ __align__(16) bf16 Ks[BK * LDK];  // [key][d]
  __shared__ __align__(16) bf16 Vs[BK * LDK];  // [key][d]
  __shared__ float kbias[MASK ? BK : 1];       // (km - 1) * 1e30 of the staged keys

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H;
  const int r0 = blockIdx.x * BQ + 16 * warp + g, r1 = r0 + 8;
  const size_t base = (size_t)bh * L * D;

  uint32_t qa[KSTEPS][4];
  {
    const bf16* q0p = q + base + (size_t)r0 * D + 2 * t;
    const bf16* q1p = q + base + (size_t)r1 * D + 2 * t;
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) {
      qa[s][0] = *reinterpret_cast<const uint32_t*>(q0p + 16 * s);
      qa[s][1] = *reinterpret_cast<const uint32_t*>(q1p + 16 * s);
      qa[s][2] = *reinterpret_cast<const uint32_t*>(q0p + 16 * s + 8);
      qa[s][3] = *reinterpret_cast<const uint32_t*>(q1p + 16 * s + 8);
    }
  }

  float o[DT][4];
#pragma unroll
  for (int jd = 0; jd < DT; ++jd) o[jd][0] = o[jd][1] = o[jd][2] = o[jd][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // running max of rows r0, r1 (kFull, kFp32Exp)
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sums

  for (int k0 = 0; k0 < L; k0 += BK) {
    __syncthreads();  // previous tile consumed
    constexpr int CPR = D / 8;
    for (int c = tid; c < BK * CPR; c += NT) {
      const int r = c / CPR, cc = c % CPR;
      *reinterpret_cast<uint4*>(&Ks[r * LDK + 8 * cc]) =
          *reinterpret_cast<const uint4*>(k + base + (size_t)(k0 + r) * D + 8 * cc);
      *reinterpret_cast<uint4*>(&Vs[r * LDK + 8 * cc]) =
          *reinterpret_cast<const uint4*>(v + base + (size_t)(k0 + r) * D + 8 * cc);
    }
    if (MASK)
      for (int i = tid; i < BK; i += NT) kbias[i] = (km[(size_t)b * L + k0 + i] - 1.0f) * kBig;
    __syncthreads();

    // S = Q K^T  (16 x BK per warp, fp32)
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
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
    if (MASK) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float ba = kbias[8 * j + 2 * t], bb = kbias[8 * j + 2 * t + 1];
        s[j][0] += ba;
        s[j][1] += bb;
        s[j][2] += ba;
        s[j][3] += bb;
      }
    }

    // P as bf16 pairs in the PV product's A-fragment layout: pp[j][0] holds
    // row r0's two columns of fragment j, pp[j][1] row r1's
    uint32_t pp[NJ][2];
    float ps0 = 0.f, ps1 = 0.f;
    if (MODE == kMatmulsOnly) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        pp[j][0] = pack_bf16(s[j][0], s[j][1]);
        pp[j][1] = pack_bf16(s[j][2], s[j][3]);
      }
    } else if (MODE == kNoMax) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        pp[j][0] = ex2_bf16x2(pack_bf16(s[j][0], s[j][1]));
        pp[j][1] = ex2_bf16x2(pack_bf16(s[j][2], s[j][3]));
        const float2 a = unpack_bf16x2(pp[j][0]), c = unpack_bf16x2(pp[j][1]);
        ps0 += a.x + a.y;
        ps1 += c.x + c.y;
      }
      l0 += ps0;
      l1 += ps1;
    } else {  // kFull, kFp32Exp: running max over the tile's keys
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
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
      for (int j = 0; j < NJ; ++j) {
        if (MODE == kFull) {
          pp[j][0] = ex2_bf16x2(pack_bf16(s[j][0] - mn0, s[j][1] - mn0));
          pp[j][1] = ex2_bf16x2(pack_bf16(s[j][2] - mn1, s[j][3] - mn1));
          const float2 a = unpack_bf16x2(pp[j][0]), c = unpack_bf16x2(pp[j][1]);
          ps0 += a.x + a.y;
          ps1 += c.x + c.y;
        } else {
          const float p0 = exp2f(s[j][0] - mn0), p1 = exp2f(s[j][1] - mn0);
          const float p2 = exp2f(s[j][2] - mn1), p3 = exp2f(s[j][3] - mn1);
          ps0 += p0 + p1;
          ps1 += p2 + p3;
          pp[j][0] = pack_bf16(p0, p1);
          pp[j][1] = pack_bf16(p2, p3);
        }
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

    // O += P V: two adjacent 8-wide P fragments are the A operand of one k-step
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {pp[2 * kk][0], pp[2 * kk][1], pp[2 * kk + 1][0], pp[2 * kk + 1][1]};
#pragma unroll
      for (int jp = 0; jp < DT / 2; ++jp) {  // two 8-wide slices of D per transposing ldmatrix
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
  bf16* o0p = out + base + (size_t)r0 * D + 2 * t;
  bf16* o1p = out + base + (size_t)r1 * D + 2 * t;
#pragma unroll
  for (int jd = 0; jd < DT; ++jd) {
    *reinterpret_cast<__nv_bfloat162*>(o0p + 8 * jd) = __floats2bfloat162_rn(o[jd][0] / d0, o[jd][1] / d0);
    *reinterpret_cast<__nv_bfloat162*>(o1p + 8 * jd) = __floats2bfloat162_rn(o[jd][2] / d1, o[jd][3] / d1);
  }
}

template <int MODE, bool MASK, int WARPS, int BK>
static int launch_probe(const void* q, const void* k, const void* v, const void* km, void* out, int B, int H, int L,
                        cudaStream_t stream) {
  dim3 grid(L / (16 * WARPS), B * H);
  probe_fwd_kernel<MODE, MASK, WARPS, BK><<<grid, 32 * WARPS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(km), static_cast<bf16*>(out), H, L);
  return (int)cudaGetLastError();
}

// The instantiated tile shapes: (query rows, keys) in {64, 128} x {64, 128}.
template <int MODE, bool MASK>
static int launch_probe_tiles(const void* q, const void* k, const void* v, const void* km, void* out, int B, int H,
                              int L, int block_q, int block_k, cudaStream_t s) {
  if (block_q == 64 && block_k == 64) return launch_probe<MODE, MASK, 4, 64>(q, k, v, km, out, B, H, L, s);
  if (block_q == 64 && block_k == 128) return launch_probe<MODE, MASK, 4, 128>(q, k, v, km, out, B, H, L, s);
  if (block_q == 128 && block_k == 64) return launch_probe<MODE, MASK, 8, 64>(q, k, v, km, out, B, H, L, s);
  if (block_q == 128 && block_k == 128) return launch_probe<MODE, MASK, 8, 128>(q, k, v, km, out, B, H, L, s);
  return (int)cudaErrorInvalidValue;
}

static bool probe_shape_ok(int B, int H, int L, int D, int block_q, int block_k) {
  return B > 0 && H > 0 && L > 0 && D == kProbeD && (long long)B * H <= 65535 && L % block_q == 0 &&
         L % block_k == 0;
}

}  // namespace srhep

// K10: q, k, v, out (B, H, L, D) contiguous bf16, D = 64; mode 0 matmuls_only,
// 1 no_max, 2 full, 3 fp32_exp; block_q, block_k in {64, 128} dividing L.
// Returns cudaGetLastError().
extern "C" int srhep_probe_variant(const void* q, const void* k, const void* v, void* out, int B, int H, int L,
                                   int D, int mode, int block_q, int block_k, void* stream) {
  using namespace srhep;
  if (!probe_shape_ok(B, H, L, D, block_q, block_k)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kMatmulsOnly:
      return launch_probe_tiles<kMatmulsOnly, false>(q, k, v, nullptr, out, B, H, L, block_q, block_k, s);
    case kNoMax:
      return launch_probe_tiles<kNoMax, false>(q, k, v, nullptr, out, B, H, L, block_q, block_k, s);
    case kFull:
      return launch_probe_tiles<kFull, false>(q, k, v, nullptr, out, B, H, L, block_q, block_k, s);
    case kFp32Exp:
      return launch_probe_tiles<kFp32Exp, false>(q, k, v, nullptr, out, B, H, L, block_q, block_k, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// K11: as K10 in mode full (exp_bf16 = 1) or fp32_exp (exp_bf16 = 0) with the
// additive key mask (km - 1) * 1e30; km (B, L) float32 contiguous.
extern "C" int srhep_probe_exp_dtype(const void* q, const void* k, const void* v, const void* km, void* out, int B,
                                     int H, int L, int D, int exp_bf16, int block_q, int block_k, void* stream) {
  using namespace srhep;
  if (!probe_shape_ok(B, H, L, D, block_q, block_k) || km == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return exp_bf16 ? launch_probe_tiles<kFull, true>(q, k, v, km, out, B, H, L, block_q, block_k, s)
                  : launch_probe_tiles<kFp32Exp, true>(q, k, v, km, out, B, H, L, block_q, block_k, s);
}
