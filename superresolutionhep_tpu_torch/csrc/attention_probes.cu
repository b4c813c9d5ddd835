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
//   * s = q k^T in fp32 on the RAW q (no scale, no base-2 fold, no clip): the
//     logits go straight into exp2;
//   * kMatmulsOnly: acc += bf16(s) v; l stays 0, so out = acc / 1e-30;
//   * kNoMax:       p = exp2(bf16(s)) computed in bf16; l += sum(p) (fp32 sum
//                   of the bf16 p); acc += p v;
//   * kFull:        online softmax with a running max over each key tile,
//                   p = exp2(bf16(s - m)) computed in bf16, alpha =
//                   exp2(m_prev - m) in fp32;
//   * kFp32Exp:     the same with p = exp2(s - m) in fp32, cast to bf16 for PV;
//   * out = bf16(acc / max(l, 1e-30)).
// Every key tile is visited: a tile that is fully masked while m is still
// -1e30 gives p = 1 for its keys (s - m = 0); alpha = 0 wipes them out once a
// valid tile arrives, and a row without any valid key comes out as the mean
// of v.  That is the TPU kernel's behaviour and this kernel's too.
//
// The exp dtype is real, since the probes exist to measure it: the bf16 modes
// run ex2.approx.ftz.bf16x2 on (s - m) packed to bf16 pairs (two bf16
// exponentials per special-function instruction), and the packed result is
// the P operand of the P V product as it stands; the f32 mode ex2.approx.f32.
// At D = 64 the exp count B*H*L^2 = 2.7e8 at (8, 8, 2048) is about as costly
// on the SFU as the products are on the tensor cores: NVIDIA's table of
// arithmetic instruction throughput gives 16 f32 exp2 results per clock per
// SM for compute capability 9.0 (2.7e8 / (16 * 132 SMs * 1.98 GHz) = 0.064 ms
// against 4*B*H*L^2*D / 989 TFLOP/s = 0.070 ms); the bf16x2 form halves the
// instruction count (0.032 ms if it issues at the f32 rate, which is assumed,
// not documented).  chip_smoke.py prints both bounds beside the times.
//
// What bounds it on the card: operations, 4*B*H*L^2*D against one read of q,
// k, v and one write of out (~1000 flop/byte at L = 2048), and, as said, the
// exponentials.  The design is the shipped forward's, the same source
// (flash_fwd.cuh: a TMA producer warp feeding a K/V mbarrier ring, one or
// three wgmma consumer warpgroups taking turns, S_{j+1} issued before P_j V_j
// at 64-key tiles), with this file's policy, ProbeSoftmax: the raw softmax of
// the mode above, the key mask carried as its additive fp32 bias (the stage's
// key words), no tile skipped, output (B, H, L, D).
//
// What is not carried over: the TPU grid's sequential key axis with its m, l,
// acc scratch becomes a loop over key tiles inside the block, with m, l and
// the output accumulator in registers; the TPU's block sweep (BQ, BK up to
// 2048, with VMEM overflow as the skipped case) becomes a sweep over the tile
// shapes instantiated here: the shipped body's query tiles (64 rows, NC = 1;
// 192 rows, NC = 3) times BK = 64 keys, and 192 rows times 128 keys (the
// running max then spans 128 keys before any exponential, and a tile runs S,
// softmax, P V in turn: S, P and O of a 128-key tile do not fit the
// registers of the overlap).
// Layout: q, k, v, out (B, H, L, D) contiguous, as the scripts hold them, read
// by the TMA as (B, L, H, D) views (strides of L, H: D, L * D); D = 64; L a
// multiple of BK (the last query tile may be ragged).
#include "flash_fwd.cuh"

namespace srhep {

constexpr int kProbeD = 64;
enum ProbeMode { kMatmulsOnly = 0, kNoMax = 1, kFull = 2, kFp32Exp = 3 };

// Two bf16 exponentials base 2 in one special-function instruction.
__device__ __forceinline__ uint32_t ex2_bf16x2(uint32_t x) {
  uint32_t y;
  asm("ex2.approx.ftz.bf16x2 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// The probes' policy of the forward body (flash_fwd.cuh).  Key words: the
// key's additive bias (km - 1) * 1e30 as fp32 bits (MASK), else 0.  In the
// bf16 modes the softmax leaves s - m (no_max: s) in s, and pack rounds it to
// bf16 pairs and takes their exponentials, whose packed words are P; the row
// sum l, that of the bf16 p in fp32, is taken by the tensor cores beside P V
// (kRowSum: one 64 x 8 product a 16-key step instead of an unpack and an add
// per element on the CUDA cores, which bound the softmax).
template <int MODE, bool MASK, int BK> struct ProbeSoftmax {
  static constexpr int kBK = BK;
  static constexpr bool kSeg = false, kSkipDead = false, kOverlap = BK == ::srhep::kBK, kLse = false;
  static constexpr bool kRescale = MODE == kFull || MODE == kFp32Exp, kRowSum = MODE == kNoMax || MODE == kFull;
  static __device__ __forceinline__ int key(const void* kmask, size_t i) {
    return MASK ? __float_as_int((static_cast<const float*>(kmask)[i] - 1.0f) * kBig) : 0;
  }
  static __device__ __forceinline__ bool query_valid(const void*, size_t) { return true; }
  static __device__ __forceinline__ int query_id(const void*, size_t) { return 0; }
  static __device__ __forceinline__ size_t out_row(int b, int h, int r, int H, int L) {
    return ((size_t)b * H + h) * L + r;
  }
  static __device__ __forceinline__ void tile(float (&s)[BK / 2], const int* bias, int t, int, int, float& m0,
                                              float& m1, float& l0, float& l1, float& al0, float& al1) {
    if (MASK) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const float2 bb = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * t);
        s[4 * j] += bb.x;
        s[4 * j + 1] += bb.y;
        s[4 * j + 2] += bb.x;
        s[4 * j + 3] += bb.y;
      }
    }
    al0 = al1 = 1.f;
    if (MODE == kMatmulsOnly || MODE == kNoMax) return;
    // running max over the tile's BK keys: NP partial maxima a row, then a
    // tree (a chain's latency is on each warpgroup's path from its S to its
    // next products); at 128 keys the registers allow two
    constexpr int NP = BK == 64 ? 8 : 2;
    float x0[NP], x1[NP];
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      x0[j] = fmaxf(s[4 * j], s[4 * j + 1]);
      x1[j] = fmaxf(s[4 * j + 2], s[4 * j + 3]);
    }
#pragma unroll
    for (int j = NP; j < BK / 8; ++j) {
      x0[j % NP] = fmaxf(x0[j % NP], fmaxf(s[4 * j], s[4 * j + 1]));
      x1[j % NP] = fmaxf(x1[j % NP], fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int w = NP / 2; w > 0; w /= 2) {
#pragma unroll
      for (int j = 0; j < w; ++j) {
        x0[j] = fmaxf(x0[j], x0[j + w]);
        x1[j] = fmaxf(x1[j], x1[j + w]);
      }
    }
    float mx0 = x0[0], mx1 = x1[0];
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    al0 = ex2(m0 - mn0);
    al1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      if (MODE == kFp32Exp) {
        s[4 * j] = ex2(s[4 * j] - mn0);
        s[4 * j + 1] = ex2(s[4 * j + 1] - mn0);
        s[4 * j + 2] = ex2(s[4 * j + 2] - mn1);
        s[4 * j + 3] = ex2(s[4 * j + 3] - mn1);
        ps0 += s[4 * j] + s[4 * j + 1];
        ps1 += s[4 * j + 2] + s[4 * j + 3];
      } else {  // kFull: s - m, exponentiated in pack
        s[4 * j] -= mn0;
        s[4 * j + 1] -= mn0;
        s[4 * j + 2] -= mn1;
        s[4 * j + 3] -= mn1;
      }
    }
    if (MODE == kFp32Exp) {
      l0 = l0 * al0 + ps0;
      l1 = l1 * al1 + ps1;
    }
  }
  static __device__ __forceinline__ void pack(const float (&s)[BK / 2], uint32_t (&p)[BK / 4]) {
    if (MODE == kMatmulsOnly || MODE == kFp32Exp) {
      pack_p(s, p);
    } else {  // kNoMax, kFull: (s - m) rounded to bf16 pairs, then exp2 in bf16
#pragma unroll
      for (int i = 0; i < BK / 4; ++i) p[i] = ex2_bf16x2(pack_bf16(s[2 * i], s[2 * i + 1]));
    }
  }
};

// q, k, v: tensor maps over the (B, L, H, D) views of (B, H, L, D) tensors;
// km (B, L) fp32 (MASK) or null; out (B, H, L, D).
template <int MODE, bool MASK, int NC, int BK>
__global__ void __launch_bounds__(128 * (NC + 1), FwdRegs<NC>::kMinBlocks)
probe_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv, const float* __restrict__ km, bf16* __restrict__ out,
                       int H, int L) {
  fwd_wgmma_body<kProbeD, NC, ProbeSoftmax<MODE, MASK, BK>>(tq, tk, tv, nullptr, km, nullptr, out, nullptr, H, L, L);
}

template <int MODE, bool MASK, int NC, int BK>
static int launch_probe(const void* q, const void* k, const void* v, const void* km, void* out, int B, int H, int L,
                        cudaStream_t stream) {
  constexpr int D = kProbeD, smem = fwd_smem_bytes<D, NC, BK>();
  static int allowed = 0;  // this instantiation's shared-memory opt-in, on its first launch
  const cudaError_t opt = opt_in_once(probe_fwd_wgmma_kernel<MODE, MASK, NC, BK>, smem, allowed);
  if (opt != cudaSuccess) return (int)opt;
  // (B, H, L, D) contiguous as (B, L, H, D) views: strides of B, L, H in elements
  const Strides st{(long long)H * L * D, D, (long long)L * D};
  CUtensorMap tq, tk, tv;
  if (!encode_operand(&tq, q, D, L, H, B, st) || !encode_operand(&tk, k, D, L, H, B, st) ||
      !encode_operand(&tv, v, D, L, H, B, st))
    return (int)cudaErrorInvalidValue;
  dim3 grid((L + 64 * NC - 1) / (64 * NC), H, B);
  probe_fwd_wgmma_kernel<MODE, MASK, NC, BK><<<grid, 128 * (NC + 1), smem, stream>>>(
      tq, tk, tv, static_cast<const float*>(km), static_cast<bf16*>(out), H, L);
  return (int)cudaGetLastError();
}

// The instantiated tile shapes (ops/attention_probes.py::TILES): query rows
// 64 (NC = 1) or 192 (NC = 3) times 64 keys, and 192 x 128.  64 x 128 is not
// built: at the 128 registers a thread of its two blocks an SM, the masked
// modes spilled (PERF.md).
template <int MODE, bool MASK>
static int launch_probe_tiles(const void* q, const void* k, const void* v, const void* km, void* out, int B, int H,
                              int L, int block_q, int block_k, cudaStream_t s) {
  if (block_q == 64 && block_k == 64) return launch_probe<MODE, MASK, 1, 64>(q, k, v, km, out, B, H, L, s);
  if (block_q == 192 && block_k == 64) return launch_probe<MODE, MASK, 3, 64>(q, k, v, km, out, B, H, L, s);
  if (block_q == 192 && block_k == 128) return launch_probe<MODE, MASK, 3, 128>(q, k, v, km, out, B, H, L, s);
  return (int)cudaErrorInvalidValue;
}

static bool probe_shape_ok(int B, int H, int L, int D, int block_k) {
  return B > 0 && H > 0 && L > 0 && D == kProbeD && B <= 65535 && H <= 65535 && block_k > 0 && L % block_k == 0;
}

}  // namespace srhep

// K10: q, k, v, out (B, H, L, D) contiguous bf16, D = 64; mode 0 matmuls_only,
// 1 no_max, 2 full, 3 fp32_exp; (block_q, block_k) one of (64, 64), (192, 64),
// (192, 128), block_k dividing L.  Returns cudaGetLastError().
extern "C" int srhep_probe_variant(const void* q, const void* k, const void* v, void* out, int B, int H, int L,
                                   int D, int mode, int block_q, int block_k, void* stream) {
  using namespace srhep;
  if (!probe_shape_ok(B, H, L, D, block_k)) return (int)cudaErrorInvalidValue;
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
  if (!probe_shape_ok(B, H, L, D, block_k) || km == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return exp_bf16 ? launch_probe_tiles<kFull, true>(q, k, v, km, out, B, H, L, block_q, block_k, s)
                  : launch_probe_tiles<kFp32Exp, true>(q, k, v, km, out, B, H, L, block_q, block_k, s);
}
