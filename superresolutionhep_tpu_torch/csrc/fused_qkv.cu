// Fused LayerNorm + adaLN modulate + QKV projection for Hopper (sm_90a).
//
// Replaces the TPU kernel superresolutionhep_tpu/ops/fused_qkv.py::_kernel
// (called through _pallas_ln_mod_proj).  Computes, per row of x (M = B*L rows
// of F values):
//     xhat = LayerNorm_noaffine(x)          fp32, two-pass, eps 1e-5
//     y    = xhat * eff_a + eff_b           modulation rows per batch row, per
//                                           cell, or per segment (common.cuh::mod_row)
//     out  = cast(y) @ W + bias             y cast to the weight type BEFORE the
//                                           product, fp32 accumulate, bias in fp32
// and writes out as a (M, O) row-major buffer, i.e. (B, L, 3F): the layout in
// which the attention kernels read Q/K/V with the head dim contiguous.  The
// TPU version's transposed (O, L) output, there to fill a 128-lane matrix
// unit, is dropped in favour of row-major stores.
//
// What bounds it on the card: bytes.  At F=256, O=768 the product does 2*F*O
// = 393k operations per row against (F + O) * 2 = 2 KB of traffic per row,
// ~190 flop/byte, under the H100's ~295; the per-segment rows of a packed
// batch are a few KB per row of 5120 cells, where per-cell rows cost 2 KB a
// cell.  The weight (384 KB in bf16) does not fit in shared memory beside an
// activation tile and lives in L2.
//
// The bf16 design (fused_qkv_wgmma_kernel): persistent blocks, one per SM,
// each walking 128-row tiles; one producer thread streams the weight through
// a ring of four 128 x 64 slabs by TMA (128-byte swizzle), another the raw
// rows of each warpgroup's next tile, both in flight while the tensor cores
// work; two consumer warpgroups of 64 rows each
//   * normalise and modulate their rows in registers (fp32, four rows per
//     warp at a time so that the shuffle reductions overlap, the modulation
//     rows' reads issued ahead of them), and write the bf16 A operand into
//     128-byte-swizzled shared memory;
//   * run wgmma.m64n128k16 with A and B from shared memory, chunk by chunk of
//     128 output columns; a 128-row tile reads each weight slab from L2 once
//     for both warpgroups;
//   * add the bias in registers and hand each chunk to the TMA through a
//     swizzled staging tile, so that the output's stores run on under the
//     next chunk's products.
// Each slab's products are waited for before the next slab's barrier is: a
// branch between a wgmma and its wait makes ptxas serialise every wgmma of
// the function (PERF.md); the two warpgroups interleave instead.
// The fp32 build (fused_qkv_f32_kernel: 64-row blocks, 4 warps, FMA tiles,
// two cp.async weight slabs) exists to hold the arithmetic tightly against
// the plain PyTorch version.
#include "common.cuh"

namespace srhep {

constexpr int kQkvStages = 4;
constexpr int kQkvLnRows = 4;  // rows a warp normalises at a time

template <int F> constexpr int qkv_smem_bytes() {
  return 1024 + 2 * kFusedNC * 64 * F * 2 + kFusedNC * 64 * kFusedBN * 2 + kQkvStages * kFusedSlabBytes +
         8 * (2 * kQkvStages + 2 * kFusedNC);
}
// the fp32 body: the normalised tile, two weight slabs, the output tile, rows padded by 16 bytes
static int qkv_f32_smem_bytes(int F) { return (kTileM * (F + 4) + 2 * kTileN * (kSlabK + 4) + kTileM * (kTileN + 4)) * 4; }

// ---------------------------------------------------------------------------
// bf16: tw = the (O, F) weight as a 2-d tensor map, box (64, 128); tx = the
// (M, F) activations, box (F, 64), plain rows; to = the (M, O) output, box
// (64, 64)
// ---------------------------------------------------------------------------
template <int F>
__global__ void __launch_bounds__(kFusedThreads, 1)
fused_qkv_wgmma_kernel(const __grid_constant__ CUtensorMap tw, const __grid_constant__ CUtensorMap tx,
                       const __grid_constant__ CUtensorMap to, const float* __restrict__ ea,
                       const float* __restrict__ eb, const float* __restrict__ bias, const int* __restrict__ seg,
                       int M, int L, int O, int mode, int e1) {
  constexpr int NCH = F / 128;       // 4-element groups per lane and row (warp_layernorm_rows)
  constexpr int KS = F / kFusedBK;   // weight slabs per output chunk
  constexpr int XS = 64 * F * 2;     // bytes of a warpgroup's activation (and A) tile
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment: the period of the 128-byte swizzle, which TMA and wgmma both apply by address
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* As = base;                                  // [NC][F/64][64][128 B] normalised rows
  unsigned char* Xs = As + kFusedNC * XS;                    // [NC][64][F] raw rows of the next tile
  unsigned char* Cs = Xs + kFusedNC * XS;                    // [NC][2][64][128 B] output staging
  unsigned char* ring = Cs + kFusedNC * 64 * kFusedBN * 2;   // [stages][128][128 B] weight slabs
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kQkvStages * kFusedSlabBytes);
  uint64_t* empty = full + kQkvStages;
  uint64_t* xfull = empty + kQkvStages;   // [NC]: a warpgroup's rows have landed
  uint64_t* xempty = xfull + kFusedNC;    // [NC]: a warpgroup has read its rows

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kQkvStages; ++s) {
      mbar_init(&full[s], 1);               // the producer's arrival with the TMA bytes
      mbar_init(&empty[s], 128 * kFusedNC);  // every consumer thread
    }
    for (int w = 0; w < kFusedNC; ++w) {
      mbar_init(&xfull[w], 1);
      mbar_init(&xempty[w], 128);
    }
    fence_mbar_init();
  }
  __syncthreads();
  const int ntiles = (M + kFusedRows - 1) / kFusedRows, nchunks = O / kFusedBN;
  // warp-uniform as far as the compiler can see, so that the wgmma
  // descriptors derived from it live in uniform registers
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);

  if (wg == kFusedNC) {
    // ============ producers: one thread streams the weight, another the rows ============
    if (tid == 128 * kFusedNC) {
      int stage = 0;
      unsigned phase = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x)
        for (int nc = 0; nc < nchunks; ++nc)
          for (int ks = 0; ks < KS; ++ks) {
            mbar_wait(&empty[stage], phase ^ 1);
            mbar_arrive_expect_tx(&full[stage], kFusedSlabBytes);
            tma_load_2d(ring + stage * kFusedSlabBytes, &tw, &full[stage], ks * kFusedBK, nc * kFusedBN);
            if (++stage == kQkvStages) {
              stage = 0;
              phase ^= 1;
            }
          }
    } else if (tid == 128 * kFusedNC + 32) {
      unsigned phase = 0;
      for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
        for (int w = 0; w < kFusedNC; ++w) {
          mbar_wait(&xempty[w], phase ^ 1);
          mbar_arrive_expect_tx(&xfull[w], XS);
          tma_load_2d(Xs + w * XS, &tx, &xfull[w], 0, tile * kFusedRows + 64 * w);
        }
        phase ^= 1;
      }
    }
    return;
  }

  // ======================= consumer warpgroups =======================
  const int warp = (tid % 128) >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const bool leader = tid % 128 == 0;
  const unsigned char* X = Xs + wg * XS;
  unsigned char* C = Cs + wg * 64 * kFusedBN * 2;
  const uint32_t a_s = smem_u32(As) + wg * XS, ring_s = smem_u32(ring);
  int stage = 0;
  unsigned phase = 0, xphase = 0;
  // lane r (< 16) holds the segment id of the warp's row r of the next tile,
  // read while the tensor cores work on the current one
  auto fetch_seg = [&](int tile) {
    return seg_of(min(tile * kFusedRows + 64 * wg + 16 * warp + (lane & 15), M - 1), mode, seg);
  };
  int sn = fetch_seg(blockIdx.x);
  FUSED_CLOCKS;  // slots: 0 tiles, 1 prologue, 2 slab waits, 3 products, 4 epilogue, 5 whole tile
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    FUSED_TIC(t_tile);
    const int row0 = tile * kFusedRows + 64 * wg;
    mbar_wait(&xfull[wg], xphase);
    xphase ^= 1;
    // LayerNorm + folded affine: each warp takes its 16 rows kQkvLnRows at a
    // time, the modulation rows' reads issued before the reductions that they
    // wait under.  Rows past M read zeros (never stored).
#pragma unroll
    for (int rr = 0; rr < 16; rr += kQkvLnRows) {
      float v[kQkvLnRows][kMaxChunks][4];
      float4 a4[kQkvLnRows][NCH], b4[kQkvLnRows][NCH];
#pragma unroll
      for (int j = 0; j < kQkvLnRows; ++j) {
        const int r = 16 * warp + rr + j;
        const size_t prow = mod_row_of(min(row0 + r, M - 1), L, mode, __shfl_sync(0xffffffffu, sn, rr + j), e1) * F;
#pragma unroll
        for (int i = 0; i < NCH; ++i) {
          const int f = 4 * (lane + 32 * i);
          a4[j][i] = *reinterpret_cast<const float4*>(ea + prow + f);
          b4[j][i] = *reinterpret_cast<const float4*>(eb + prow + f);
          bf16x4_to_float(*reinterpret_cast<const uint2*>(X + (r * F + f) * 2), v[j][i]);
        }
      }
      warp_layernorm_rows<kQkvLnRows>(v, NCH, F);
#pragma unroll
      for (int j = 0; j < kQkvLnRows; ++j)
#pragma unroll
        for (int i = 0; i < NCH; ++i) {
          const float y[4] = {v[j][i][0] * a4[j][i].x + b4[j][i].x, v[j][i][1] * a4[j][i].y + b4[j][i].y,
                              v[j][i][2] * a4[j][i].z + b4[j][i].z, v[j][i][3] * a4[j][i].w + b4[j][i].w};
          sts_bf16x4(a_s + swz_a_offset(16 * warp + rr + j, 4 * (lane + 32 * i)), y);
        }
    }
    mbar_arrive(&xempty[wg]);  // the rows are read: the next tile's may land
    fence_proxy_async();
    named_bar_sync(1 + wg, 128);  // the warpgroup's A tile is complete
    if (tile + gridDim.x < ntiles) sn = fetch_seg(tile + gridDim.x);
    FUSED_TOC(1, t_tile);

    for (int nc = 0; nc < nchunks; ++nc) {
      const int n0 = nc * kFusedBN;
      float2 bb[kFusedBN / 8];  // this thread's bias pairs of the chunk, loaded under the products
#pragma unroll
      for (int j = 0; j < kFusedBN / 8; ++j) bb[j] = *reinterpret_cast<const float2*>(bias + n0 + 8 * j + 2 * t);
      float acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        FUSED_TIC(t_wait);
        mbar_wait(&full[stage], phase);
        FUSED_TOC(2, t_wait);
        FUSED_TIC(t_mma);
        const uint32_t slab = ring_s + stage * kFusedSlabBytes;
        uint64_t da[4], db[4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {  // K-major: the next 16-deep k-step is 32 bytes further
          da[kk] = gmma_desc(a_s + ks * 8192 + 32 * kk, 1024, 1);
          db[kk] = gmma_desc(slab + 32 * kk, 1024, 1);
          asm volatile("" : "+l"(da[kk]), "+l"(db[kk]));
        }
        fence_operand(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_ss_m64n128k16(acc, da[kk], db[kk], 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_operand(acc);
        FUSED_TOC(3, t_mma);
        mbar_arrive(&empty[stage]);
        if (++stage == kQkvStages) {
          stage = 0;
          phase ^= 1;
        }
      }
      // epilogue: bias in registers, bf16 pairs into the staging tile, which
      // one thread hands to the TMA as two 64 x 64 boxes (rows past M are not
      // written); the stores run on under the next chunk's products, and the
      // staging tile is rewritten only once they have read it
      FUSED_TIC(t_epi);
      if (leader) bulk_wait_read<0>();
      named_bar_sync(1 + wg, 128);
      const int r0 = 16 * warp + g, r1 = r0 + 8;
#pragma unroll
      for (int j = 0; j < kFusedBN / 8; ++j) {
        *reinterpret_cast<uint32_t*>(C + swz_c_offset(r0, j) + 4 * t) =
            pack_bf16(acc[4 * j] + bb[j].x, acc[4 * j + 1] + bb[j].y);
        *reinterpret_cast<uint32_t*>(C + swz_c_offset(r1, j) + 4 * t) =
            pack_bf16(acc[4 * j + 2] + bb[j].x, acc[4 * j + 3] + bb[j].y);
      }
      fence_proxy_async();
      named_bar_sync(1 + wg, 128);
      if (leader) {
        tma_store_2d(&to, smem_u32(C), n0, row0);
        tma_store_2d(&to, smem_u32(C) + 8192, n0 + 64, row0);
        bulk_commit();
      }
      FUSED_TOC(4, t_epi);
    }
    FUSED_TOC(5, t_tile);
    FUSED_TILE_DONE();
  }
  if (leader) bulk_wait<0>();  // the last stores have finished before the block's shared memory goes
  FUSED_CLOCKS_FLUSH();
}

// ---------------------------------------------------------------------------
// fp32: 64 rows a block, 4 warps, FMA tiles from shared memory
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
fused_qkv_f32_kernel(const float* __restrict__ x, const float* __restrict__ ea, const float* __restrict__ eb,
                     const float* __restrict__ w /* (O, F) */, const float* __restrict__ bias,
                     const int* __restrict__ seg, float* __restrict__ out, int M, int L, int F, int O, int mode,
                     int e1, int chunks_per_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LDS = kSlabK + 4;
  constexpr int LDC = kTileN + 4;
  const int lda = F + 4;
  float* As = reinterpret_cast<float*>(smem_raw);  // [64][F + pad]      normalised, modulated rows
  float* Ws = As + kTileM * lda;                   // 2 x [64][128 + pad] weight slabs
  float* Cs = Ws + 2 * kTileN * LDS;               // [64][64 + pad]      output tile on its way out

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
      const float* xr = x + (size_t)rows[j] * F;
#pragma unroll
      for (int i = 0; i < kMaxChunks; ++i)
        if (i < nch) load4<float>(xr + 4 * (lane + 32 * i), v[j][i]);
    }
    warp_layernorm_rows<2>(v, nch, F);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const size_t prow = mod_row(rows[j], L, mode, seg, e1) * F;
      float* ar = As + (16 * warp + rr + j) * lda;
#pragma unroll
      for (int i = 0; i < kMaxChunks; ++i)
        if (i < nch) {
          const int f = 4 * (lane + 32 * i);
          const float4 a4 = *reinterpret_cast<const float4*>(ea + prow + f);
          const float4 b4 = *reinterpret_cast<const float4*>(eb + prow + f);
          const float y[4] = {v[j][i][0] * a4.x + b4.x, v[j][i][1] * a4.y + b4.y,
                              v[j][i][2] * a4.z + b4.z, v[j][i][3] * a4.w + b4.w};
          store4<float>(ar + f, y);
        }
    }
  }

  const int nc_begin = blockIdx.y * chunks_per_block;
  const int nc_end = min(nc_begin + chunks_per_block, O / kTileN);
  tile_gemm_chunks<float>(As, lda, w, F, nc_begin, nc_end, Ws, [&](int n0, const float(&acc)[32]) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      int r, c;
      TileMma<float>::coord(i, r, c);
      Cs[r * LDC + c] = acc[i] + bias[n0 + c];
    }
    __syncthreads();
    // 64 rows x 16 16-byte pieces; a warp writes whole 128-byte row segments
    for (int p = threadIdx.x; p < kTileM * (kTileN / 4); p += kThreads) {
      const int r = p / (kTileN / 4), cc = p % (kTileN / 4);
      if (row0 + r < M)
        *reinterpret_cast<float4*>(out + (size_t)(row0 + r) * O + n0 + cc * 4) =
            *reinterpret_cast<const float4*>(Cs + r * LDC + cc * 4);
    }
    // Cs is written again only after the next chunk's products, behind two block syncs
  });
}

template <int F>
static int launch_qkv_bf16(const void* x, const void* a, const void* b, const void* w, const void* bias,
                           const int* seg, void* out, int M, int L, int O, int mode, int e1, int smem,
                           cudaStream_t stream) {
  if (smem != qkv_smem_bytes<F>() || smem > 232448) return (int)cudaErrorInvalidValue;  // the wrapper's formula disagrees
  static int allowed = 0;
  const cudaError_t e = opt_in_once(fused_qkv_wgmma_kernel<F>, smem, allowed);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap tw, tx, to;
  if (!encode_matrix_bf16(&tw, w, O, F, kFusedBN, kFusedBK) || !encode_matrix_bf16(&tx, x, M, F, 64, F, false) ||
      !encode_matrix_bf16(&to, out, M, O, 64, 64))
    return (int)cudaErrorInvalidValue;
  const int ntiles = (M + kFusedRows - 1) / kFusedRows;
  fused_qkv_wgmma_kernel<F><<<ntiles < sm_count() ? ntiles : sm_count(), kFusedThreads, smem, stream>>>(
      tw, tx, to, static_cast<const float*>(a), static_cast<const float*>(b), static_cast<const float*>(bias), seg,
      M, L, O, mode, e1);
  return (int)cudaGetLastError();
}

static int launch_qkv_f32(const void* x, const void* a, const void* b, const void* w, const void* bias,
                          const int* seg, void* out, int M, int L, int F, int O, int mode, int e1, int smem,
                          cudaStream_t stream) {
  if (smem != qkv_f32_smem_bytes(F)) return (int)cudaErrorInvalidValue;
  static int allowed = 0;
  const cudaError_t e = opt_in_once(fused_qkv_f32_kernel, smem, allowed);
  if (e != cudaSuccess) return (int)e;
  // split the column chunks over grid.y only as far as it takes to put about two
  // blocks on each SM
  const int row_tiles = (M + kTileM - 1) / kTileM, chunks = O / kTileN;
  int splits = (2 * sm_count() + row_tiles - 1) / row_tiles;
  if (splits > chunks) splits = chunks;
  if (splits < 1) splits = 1;
  const int chunks_per_block = (chunks + splits - 1) / splits;
  dim3 grid(row_tiles, (chunks + chunks_per_block - 1) / chunks_per_block);
  fused_qkv_f32_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(w), static_cast<const float*>(bias), seg, static_cast<float*>(out), M, L, F, O, mode,
      e1, chunks_per_block);
  return (int)cudaGetLastError();
}

}  // namespace srhep

// x (M, F); a, b fp32 modulation rows: (B, F) (mode 0), (M, F) (mode 1) or a
// per-segment table (B, e1, F) with seg (M,) int32 (mode 2); w (O, F)
// n-major; bias fp32 (O); out (M, O).  smem: the wrapper's count of the
// block's shared memory, which must equal this layout's.  bf16: F in {128,
// 256}; fp32: F % 128 == 0, F <= 1024.  O % 128 == 0.  Returns
// cudaGetLastError().
extern "C" int srhep_fused_qkv(const void* x, const void* a, const void* b, const void* w, const void* bias,
                               const void* seg, void* out, int M, int L, int F, int O, int mode, int e1, int smem,
                               int is_bf16, void* stream) {
  using namespace srhep;
  if (M <= 0 || L <= 0 || O <= 0 || O % kFusedBN || mode < kRowsPerBatch || mode > kRowsPerSegment)
    return (int)cudaErrorInvalidValue;
  if (mode == kRowsPerSegment && (seg == nullptr || e1 < 1)) return (int)cudaErrorInvalidValue;
  const int* sg = static_cast<const int*>(seg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    switch (F) {
      case 128: return launch_qkv_bf16<128>(x, a, b, w, bias, sg, out, M, L, O, mode, e1, smem, s);
      case 256: return launch_qkv_bf16<256>(x, a, b, w, bias, sg, out, M, L, O, mode, e1, smem, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (F % 128 != 0 || F > 1024) return (int)cudaErrorInvalidValue;
  return launch_qkv_f32(x, a, b, w, bias, sg, out, M, L, F, O, mode, e1, smem, s);
}

#ifdef SRHEP_FUSED_CLOCKS
// copies the stage counters to host (8 unsigned long longs) and clears them
extern "C" int srhep_read_qkv_clocks(void* host) {
  cudaMemcpyFromSymbol(host, srhep::srhep_fused_clocks, sizeof(srhep::srhep_fused_clocks));
  const unsigned long long z[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(srhep::srhep_fused_clocks, z, sizeof(z));
}
#endif
