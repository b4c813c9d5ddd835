// Fused DiT MLP half-layer for Hopper (sm_90a).
//
// Replaces the TPU kernel superresolutionhep_tpu/ops/fused_mlp.py::_kernel
// (called through _pallas_dit_mlp).  Per row (M = B*L rows of F values):
//     h   = q + gate_a * attn                       gated residual, fp32
//     u   = LN(h) * eff_a + eff_b                   norm2 + adaLN modulate, folded
//     u2  = LN(u)                                   the MLP's own pre-linear norm
//     z   = lrelu(cast(u2) @ W0 + b0)               (F -> Fh), fp32 accumulate
//     out = h + gate_m * lrelu(cast(z) @ W1 + b1)   (Fh -> F)
// Casts sit exactly where the plain version has them: u2 and z go to the
// weight type before each product, everything else is fp32.  gate/eff rows
// are fp32, per batch (B, F) or per cell (B, L, F).
//
// What bounds it on the card: bytes, narrowly.  At F = Fh = 256 a row costs
// 4*F*Fh = 262k operations against 3 * F * 2 = 1.5 KB of traffic (q, attn in,
// out), ~170 flop/byte against the H100's ~295; the two weights (2 x 128 KB
// in bf16) do not fit beside the activation tile in the 227 KB of shared
// memory a block may use, so they stream through two 64x128 slab buffers
// (cp.async, the next slab in flight during the current products) and live in
// L2.  What the design does about it: the (64, F) normalised tile and the
// (64, Fh) hidden tile stay in shared memory between the two products, so no
// intermediate of the chain touches device memory; q and attn are read with
// 8/16-byte loads, two rows per warp at a time so that the four shuffle
// reductions of a row pair overlap; the second product's 64x64 tiles are
// staged in fp32 through the (by then dead) normalised tile's memory and the
// residual h = q + gate_a * attn is recomputed there from q and attn (an L2
// hit) with vector accesses, instead of holding h in 64 KB of shared memory.
// One block = 64 rows, 4 warps.
#include "common.cuh"

namespace srhep {

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_mlp_kernel(const T* __restrict__ q, const T* __restrict__ att, const float* __restrict__ ga,
                 const float* __restrict__ ea, const float* __restrict__ eb, const float* __restrict__ gm,
                 const T* __restrict__ w0 /* (Fh, F) */, const float* __restrict__ b0,
                 const T* __restrict__ w1 /* (F, Fh) */, const float* __restrict__ b1, T* __restrict__ out,
                 int M, int L, int F, int Fh, int per_cell) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LDS = kSlabK + Pad<T>::value;
  constexpr int LDC = kTileN + 4;  // fp32 staging tile
  const int lda = F + Pad<T>::value;
  const int ldz = Fh + Pad<T>::value;
  T* As = reinterpret_cast<T*>(smem_raw);       // [64][F + pad]        u2
  T* Zs = As + kTileM * lda;                    // [64][Fh + pad]       z
  T* Ws = Zs + kTileM * ldz;                    // 2 x [64][128 + pad]  weight slabs
  float* Cs = reinterpret_cast<float*>(smem_raw);  // [64][64 + 4] fp32, over As once As is dead

  const int row0 = blockIdx.x * kTileM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nch = F / 128;

  // residual + norm2/modulate + the MLP's pre-linear norm: each warp takes its
  // 16 rows two at a time.  Rows past M repeat row M-1 (never stored).
  for (int rr = 0; rr < 16; rr += 2) {
    float v[2][kMaxChunks][4];
    size_t prow[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = min(row0 + 16 * warp + rr + j, M - 1);
      const size_t xoff = (size_t)row * F;
      prow[j] = (size_t)(per_cell ? row : row / L) * F;
#pragma unroll
      for (int i = 0; i < kMaxChunks; ++i)
        if (i < nch) {
          const int f = 4 * (lane + 32 * i);
          float qv[4], av[4];
          load4<T>(q + xoff + f, qv);
          load4<T>(att + xoff + f, av);
          const float4 g4 = *reinterpret_cast<const float4*>(ga + prow[j] + f);
          v[j][i][0] = qv[0] + g4.x * av[0];
          v[j][i][1] = qv[1] + g4.y * av[1];
          v[j][i][2] = qv[2] + g4.z * av[2];
          v[j][i][3] = qv[3] + g4.w * av[3];
        }
    }
    warp_layernorm_rows<2>(v, nch, F);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int i = 0; i < kMaxChunks; ++i)
        if (i < nch) {
          const int f = 4 * (lane + 32 * i);
          const float4 a4 = *reinterpret_cast<const float4*>(ea + prow[j] + f);
          const float4 b4 = *reinterpret_cast<const float4*>(eb + prow[j] + f);
          v[j][i][0] = v[j][i][0] * a4.x + b4.x;
          v[j][i][1] = v[j][i][1] * a4.y + b4.y;
          v[j][i][2] = v[j][i][2] * a4.z + b4.z;
          v[j][i][3] = v[j][i][3] * a4.w + b4.w;
        }
    warp_layernorm_rows<2>(v, nch, F);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      T* ar = As + (16 * warp + rr + j) * lda;
#pragma unroll
      for (int i = 0; i < kMaxChunks; ++i)
        if (i < nch) store4<T>(ar + 4 * (lane + 32 * i), v[j][i]);
    }
  }

  // z = lrelu(u2 @ W0 + b0) -> Zs (cast to the weight type, as before the second product)
  tile_gemm_chunks<T>(As, lda, w0, F, 0, Fh / kTileN, Ws, [&](int n0, const float(&acc)[32]) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      int r, c;
      TileMma<T>::coord(i, r, c);
      Zs[r * ldz + n0 + c] = from_float<T>(lrelu(acc[i] + b0[n0 + c]));
    }
  });

  // out = h + gate_m * lrelu(z @ W1 + b1); As is dead from here on, Cs lies over it
  tile_gemm_chunks<T>(Zs, ldz, w1, Fh, 0, F / kTileN, Ws, [&](int n0, const float(&acc)[32]) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      int r, c;
      TileMma<T>::coord(i, r, c);
      Cs[r * LDC + c] = lrelu(acc[i] + b1[n0 + c]);
    }
    __syncthreads();
    for (int p = threadIdx.x; p < kTileM * (kTileN / 4); p += kThreads) {
      const int r = p / (kTileN / 4), c4 = 4 * (p % (kTileN / 4));
      const int row = row0 + r;
      if (row < M) {
        const size_t xoff = (size_t)row * F + n0 + c4;
        const size_t poff = (size_t)(per_cell ? row : row / L) * F + n0 + c4;
        float qv[4], av[4];
        load4<T>(q + xoff, qv);
        load4<T>(att + xoff, av);
        const float4 g4 = *reinterpret_cast<const float4*>(ga + poff);
        const float4 m4 = *reinterpret_cast<const float4*>(gm + poff);
        const float4 z4 = *reinterpret_cast<const float4*>(Cs + r * LDC + c4);
        const float o[4] = {(qv[0] + g4.x * av[0]) + m4.x * z4.x, (qv[1] + g4.y * av[1]) + m4.y * z4.y,
                            (qv[2] + g4.z * av[2]) + m4.z * z4.z, (qv[3] + g4.w * av[3]) + m4.w * z4.w};
        store4<T>(out + xoff, o);
      }
    }
    // Cs is written again only after the next chunk's products, behind two block syncs
  });
}

template <typename T>
static int launch_fused_mlp(const void* q, const void* att, const void* ga, const void* ea, const void* eb,
                            const void* gm, const void* w0, const void* b0, const void* w1, const void* b1,
                            void* out, int M, int L, int F, int Fh, int per_cell, cudaStream_t stream) {
  const size_t smem =
      (size_t)kTileM * ((F + Pad<T>::value) + (Fh + Pad<T>::value) + 2 * (kSlabK + Pad<T>::value)) * sizeof(T);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  static size_t smem_allowed = 0;  // see fused_qkv.cu
  if (smem > smem_allowed) {
    cudaError_t e = cudaFuncSetAttribute(fused_mlp_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_allowed = smem;
  }
  dim3 grid((M + kTileM - 1) / kTileM);
  fused_mlp_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(att), static_cast<const float*>(ga),
      static_cast<const float*>(ea), static_cast<const float*>(eb), static_cast<const float*>(gm),
      static_cast<const T*>(w0), static_cast<const float*>(b0), static_cast<const T*>(w1),
      static_cast<const float*>(b1), static_cast<T*>(out), M, L, F, Fh, per_cell);
  return (int)cudaGetLastError();
}

}  // namespace srhep

// q, attn, out (M, F); ga, ea, eb, gm fp32 (B, F) or (M, F); w0 (Fh, F) and
// w1 (F, Fh) n-major; b0 (Fh), b1 (F) fp32.  F, Fh % 128 == 0, <= 1024.
extern "C" int srhep_fused_mlp(const void* q, const void* att, const void* ga, const void* ea, const void* eb,
                               const void* gm, const void* w0, const void* b0, const void* w1, const void* b1,
                               void* out, int M, int L, int F, int Fh, int per_cell, int is_bf16, void* stream) {
  if (F % 128 != 0 || Fh % 128 != 0 || F > 1024 || Fh > 1024 || M <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return srhep::launch_fused_mlp<srhep::bf16>(q, att, ga, ea, eb, gm, w0, b0, w1, b1, out, M, L, F, Fh, per_cell, s);
  return srhep::launch_fused_mlp<float>(q, att, ga, ea, eb, gm, w0, b0, w1, b1, out, M, L, F, Fh, per_cell, s);
}
