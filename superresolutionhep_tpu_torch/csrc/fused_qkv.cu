// Fused LayerNorm + adaLN modulate + QKV projection for Hopper (sm_90a).
//
// Replaces the TPU kernel superresolutionhep_tpu/ops/fused_qkv.py::_kernel
// (called through _pallas_ln_mod_proj).  Computes, per row of x (M = B*L rows
// of F values):
//     xhat = LayerNorm_noaffine(x)          fp32, two-pass, eps 1e-5
//     y    = xhat * eff_a + eff_b           eff rows per batch (B,F) or per cell (B,L,F)
//     out  = cast(y) @ W + bias             y cast to the weight type BEFORE the
//                                           product, fp32 accumulate, bias in fp32
// and writes out as a (M, O) row-major buffer, i.e. (B, L, 3F): the layout in
// which the attention kernels read Q/K/V with the head dim contiguous.
//
// What bounds it on the card: bytes.  At F=256, O=768 the product does 2*F*O
// = 393k operations per row against (F + O) * 2 = 2 KB of traffic per row,
// ~190 flop/byte, under the H100's ~295; the weight (384 KB in bf16) stays
// in L2.  What the design does about it: the activation tile is read once
// with 8/16-byte loads, normalised in registers (two rows per warp at a time,
// so their shuffle reductions overlap) and kept in shared memory as the A
// operand, so the normalised tensor never exists in device memory; the weight
// streams through two 64x128 slab buffers with cp.async, the next slab in
// flight while the tensor cores work on the current one; each 64x64 output
// tile is staged through shared memory and leaves in full 128-byte row
// segments.  The TPU version's transposed (O, L) output, there to fill a
// 128-lane matrix unit, is dropped in favour of these row-major stores.  One
// block = 64 rows, 4 warps; it walks all O/64 column chunks of its rows, or a
// share of them when there are too few row tiles to fill the card (the
// LayerNorm is then redone per share: cheap next to idle SMs).
#include "common.cuh"

namespace srhep {

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_qkv_kernel(const T* __restrict__ x, const float* __restrict__ ea, const float* __restrict__ eb,
                 const T* __restrict__ w /* (O, F) */, const float* __restrict__ bias, T* __restrict__ out,
                 int M, int L, int F, int O, int per_cell, int chunks_per_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LDS = kSlabK + Pad<T>::value;
  constexpr int LDC = kTileN + Pad<T>::value;
  constexpr int VEC = 16 / (int)sizeof(T);
  const int lda = F + Pad<T>::value;
  T* As = reinterpret_cast<T*>(smem_raw);  // [64][F + pad]      normalised, modulated rows
  T* Ws = As + kTileM * lda;               // 2 x [64][128 + pad] weight slabs
  T* Cs = Ws + 2 * kTileN * LDS;           // [64][64 + pad]      output tile on its way out

  const int row0 = blockIdx.x * kTileM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nch = F / 128;

  // LayerNorm + folded affine: each warp takes its 16 rows two at a time.
  // Rows past M repeat row M-1 (never stored) so that no access needs a guard.
  for (int rr = 0; rr < 16; rr += 2) {
    float v[2][kMaxChunks][4];
    int rows[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      rows[j] = min(row0 + 16 * warp + rr + j, M - 1);
      const T* xr = x + (size_t)rows[j] * F;
#pragma unroll
      for (int i = 0; i < kMaxChunks; ++i)
        if (i < nch) load4<T>(xr + 4 * (lane + 32 * i), v[j][i]);
    }
    warp_layernorm_rows<2>(v, nch, F);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const size_t prow = (size_t)(per_cell ? rows[j] : rows[j] / L) * F;
      T* ar = As + (16 * warp + rr + j) * lda;
#pragma unroll
      for (int i = 0; i < kMaxChunks; ++i)
        if (i < nch) {
          const int f = 4 * (lane + 32 * i);
          const float4 a4 = *reinterpret_cast<const float4*>(ea + prow + f);
          const float4 b4 = *reinterpret_cast<const float4*>(eb + prow + f);
          const float y[4] = {v[j][i][0] * a4.x + b4.x, v[j][i][1] * a4.y + b4.y,
                              v[j][i][2] * a4.z + b4.z, v[j][i][3] * a4.w + b4.w};
          store4<T>(ar + f, y);
        }
    }
  }

  const int nc_begin = blockIdx.y * chunks_per_block;
  const int nc_end = min(nc_begin + chunks_per_block, O / kTileN);
  tile_gemm_chunks<T>(As, lda, w, F, nc_begin, nc_end, Ws, [&](int n0, const float(&acc)[32]) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      int r, c;
      TileMma<T>::coord(i, r, c);
      Cs[r * LDC + c] = from_float<T>(acc[i] + bias[n0 + c]);
    }
    __syncthreads();
    // 64 rows x (64 / VEC) 16-byte pieces; a warp writes whole 128-byte row segments
    for (int p = threadIdx.x; p < kTileM * (kTileN / VEC); p += kThreads) {
      const int r = p / (kTileN / VEC), cc = p % (kTileN / VEC);
      if (row0 + r < M)
        *reinterpret_cast<uint4*>(out + (size_t)(row0 + r) * O + n0 + cc * VEC) =
            *reinterpret_cast<const uint4*>(Cs + r * LDC + cc * VEC);
    }
    // Cs is written again only after the next chunk's products, behind two block syncs
  });
}

template <typename T>
static int launch_fused_qkv(const void* x, const void* a, const void* b, const void* w, const void* bias,
                            void* out, int M, int L, int F, int O, int per_cell, cudaStream_t stream) {
  const size_t smem = (size_t)((kTileM * (F + Pad<T>::value)) + 2 * kTileN * (kSlabK + Pad<T>::value) +
                               kTileM * (kTileN + Pad<T>::value)) * sizeof(T);
  // opt in to more than 48 KB of dynamic shared memory when a launch needs more than
  // any before it (per element type; not on every launch, so that launches can be
  // captured into a CUDA graph)
  static size_t smem_allowed = 0;
  if (smem > smem_allowed) {
    cudaError_t e = cudaFuncSetAttribute(fused_qkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_allowed = smem;
  }
  // split the column chunks over grid.y only as far as it takes to put about two
  // blocks on each of the 132 SMs
  const int row_tiles = (M + kTileM - 1) / kTileM, chunks = O / kTileN;
  int splits = (264 + row_tiles - 1) / row_tiles;
  if (splits > chunks) splits = chunks;
  if (splits < 1) splits = 1;
  const int chunks_per_block = (chunks + splits - 1) / splits;
  dim3 grid(row_tiles, (chunks + chunks_per_block - 1) / chunks_per_block);
  fused_qkv_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const T*>(w), static_cast<const float*>(bias), static_cast<T*>(out), M, L, F, O, per_cell,
      chunks_per_block);
  return (int)cudaGetLastError();
}

}  // namespace srhep

// x (M, F); a, b fp32 (B, F) or (M, F); w (O, F) n-major; bias fp32 (O); out (M, O).
// F % 128 == 0, F <= 1024, O % 64 == 0.  Returns cudaGetLastError().
extern "C" int srhep_fused_qkv(const void* x, const void* a, const void* b, const void* w, const void* bias,
                               void* out, int M, int L, int F, int O, int per_cell, int is_bf16, void* stream) {
  if (F % 128 != 0 || F > 1024 || O % 64 != 0 || M <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return srhep::launch_fused_qkv<srhep::bf16>(x, a, b, w, bias, out, M, L, F, O, per_cell, s);
  return srhep::launch_fused_qkv<float>(x, a, b, w, bias, out, M, L, F, O, per_cell, s);
}
