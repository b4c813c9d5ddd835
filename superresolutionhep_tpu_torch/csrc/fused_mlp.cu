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
// are fp32, per batch row, per cell, or per segment (common.cuh::mod_row).
//
// What bounds it on the card: bytes, narrowly.  At F = Fh = 256 a row costs
// 4*F*Fh = 262k operations against 3 * F * 2 = 1.5 KB of traffic (q, attn in,
// out), ~170 flop/byte against the H100's ~295; per-cell fp32 rows would add
// 4 KB a cell, per-segment rows a few KB per row of 5120 cells.  The two
// weights (2 x 128 KB in bf16) do not fit beside the activation tiles in the
// 227 KB of shared memory a block may use and live in L2.
//
// The bf16 design (fused_mlp_wgmma_kernel): persistent blocks, one per SM,
// walking 128-row tiles; W0's and then W1's 16 KB slabs (128 hidden columns
// x 64 deep; 64 output columns x 128 deep) stream through a two-slab TMA ring
// (128-byte swizzle) for every tile, thread 0 refilling a stage once both
// warpgroups have released it; two warpgroups of 64 rows each
//   * read their rows of q and attn once (four rows at a time, the reads four
//     rows ahead), build h in fp32 and keep it on chip (shared memory, swizzled so that the
//     epilogue's accumulator-layout reads are conflict-free), normalise,
//     modulate and normalise again in registers, and write u2 as the bf16 A
//     operand into swizzled shared memory;
//   * z = lrelu(u2 W0 + b0) by wgmma.m64n128k16 (A and B from shared memory),
//     128 hidden columns at a time; each accumulator becomes bf16 pairs in
//     registers, in exactly the fragment layout of the A operand of the
//     second product, so z never leaves registers;
//   * z W1 by wgmma.m64n64k16 with A from registers, 64 output columns at a
//     time; the epilogue adds b1, applies lrelu and the gate, adds h from
//     shared memory and hands the chunk to the TMA through a swizzled
//     staging tile over u2 (dead by then), the stores running on under the
//     next products.
// The block has no producer warp: with eight warps a thread may have 255
// registers, with a ninth (three warps on an SM sub-partition) 168, which z
// (64 registers at Fh = 256), the accumulator and the prologue's rows in
// flight outgrow.
// Each slab's products are waited for before the next slab's barrier is (a
// branch between a wgmma and its wait serialises every wgmma of the
// function); the two warpgroups interleave instead.  The shared memory of h
// (128 KB for 128 rows at F = 256) leaves room for two slabs only.
// The fp32 build (fused_mlp_f32_kernel: 64-row blocks, 4 warps, FMA tiles,
// two cp.async weight slabs, h rebuilt from q and attn in the epilogue)
// exists to hold the arithmetic tightly against the plain PyTorch version.
#include "common.cuh"

namespace srhep {

constexpr int kMlpStages = 2;
constexpr int kMlpThreads = 128 * kFusedNC;  // the consumer warpgroups, no producer warp
constexpr int kMlpLnRows = 4;  // rows a warp normalises at a time; the next ones are read meanwhile

template <int F> constexpr int mlp_smem_bytes() {
  return 1024 + kFusedNC * 64 * F * 4 + kFusedNC * 64 * F * 2 + kMlpStages * kFusedSlabBytes + 2 * kMlpStages * 8;
}
// the fp32 body: the normalised tile, the hidden tile, two weight slabs, rows padded by 16 bytes
static int mlp_f32_smem_bytes(int F, int Fh) { return kTileM * ((F + 4) + (Fh + 4) + 2 * (kSlabK + 4)) * 4; }

// byte offset of the fp32 pair (r, f), f even, in a warpgroup's [64][F] h
// tile: the pair index XORed with 4 * (r % 8), so that the epilogue's reads
// (8 rows x 4 pairs a warp) fall into distinct banks
template <int F> __device__ __forceinline__ uint32_t swz_h_offset(int r, int f) {
  return (uint32_t)(r * F * 4 + ((((f >> 1) ^ ((r & 7) << 2))) << 3));
}

// ---------------------------------------------------------------------------
// bf16: tw0 = W0 (Fh, F) and tw1 = W1 (F, Fh), n-major, as 2-d tensor maps
// with box (64, 128) and (64, 64)
// ---------------------------------------------------------------------------
template <int F, int FH>
__global__ void __launch_bounds__(kMlpThreads, 1)
fused_mlp_wgmma_kernel(const __grid_constant__ CUtensorMap tw0, const __grid_constant__ CUtensorMap tw1,
                       const __grid_constant__ CUtensorMap to, const bf16* __restrict__ q, const bf16* __restrict__ att,
                       const float* __restrict__ ga, const float* __restrict__ ea, const float* __restrict__ eb,
                       const float* __restrict__ gm, const float* __restrict__ b0, const float* __restrict__ b1,
                       const int* __restrict__ seg, int M, int L, int mode, int e1) {
  constexpr int NCH = F / 128;                    // 4-element groups per lane and row
  constexpr int KS0 = F / kFusedBK, NC0 = FH / kFusedBN;  // first product: slabs per chunk, chunks
  constexpr int KS1 = FH / (2 * kFusedBK), NC1 = F / 64;  // second product: two 64 x 64 boxes a slab, 64 columns a chunk
  constexpr int SLABS = NC0 * KS0 + NC1 * KS1;            // weight slabs a tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Hs = base;                                 // [NC][64][F] fp32 residual h
  unsigned char* Us = Hs + kFusedNC * 64 * F * 4;           // [NC][F/64][64][128 B] u2, then output staging
  unsigned char* ring = Us + kFusedNC * 64 * F * 2;         // [stages][128][128 B] weight slabs
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kMlpStages * kFusedSlabBytes);
  uint64_t* empty = full + kMlpStages;

  const int tid = threadIdx.x;
  // slab `seq` of this block's sequence (W0's slabs, then W1's, tile after
  // tile) into its ring stage: a slab of W0 is 128 hidden columns x 64 deep,
  // one of W1 64 output columns x 128 deep, as two 64 x 64 boxes
  auto issue = [&](int seq) {
    const int tile = blockIdx.x + (seq / SLABS) * gridDim.x, local = seq % SLABS;
    if (tile * kFusedRows >= M) return;
    uint64_t* bar = &full[seq % kMlpStages];
    unsigned char* dst = ring + (seq % kMlpStages) * kFusedSlabBytes;
    mbar_arrive_expect_tx(bar, kFusedSlabBytes);
    if (local < NC0 * KS0) {
      tma_load_2d(dst, &tw0, bar, (local % KS0) * kFusedBK, (local / KS0) * kFusedBN);
    } else {
      const int l1 = local - NC0 * KS0, k0 = (l1 % KS1) * 2 * kFusedBK, n0 = (l1 / KS1) * 64;
      tma_load_2d(dst, &tw1, bar, k0, n0);
      tma_load_2d(dst + 8192, &tw1, bar, k0 + kFusedBK, n0);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < kMlpStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kMlpThreads);
    }
    fence_mbar_init();
    for (int s = 0; s < kMlpStages; ++s) issue(s);
  }
  __syncthreads();
  // warp-uniform as far as the compiler can see, so that the wgmma
  // descriptors derived from it live in uniform registers
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);

  // ======================= consumer warpgroups =======================
  // no producer warp: a block of eight warps leaves each thread 255 registers
  // (a ninth would cut that to 168, too few); thread 0 refills each ring stage
  // once both warpgroups have released it
  const bool leader = tid % 128 == 0;
  const uint32_t h_s = smem_u32(Hs) + wg * 64 * F * 4, u_s = smem_u32(Us) + wg * 64 * F * 2;
  const uint32_t ring_s = smem_u32(ring);
  int stage = 0, seq = 0;
  unsigned phase = 0;
  // wait for the next slab; release it once this warpgroup's products of it are done
  auto next_slab = [&]() {
    mbar_wait(&full[stage], phase);
    return ring_s + stage * kFusedSlabBytes;
  };
  auto release_slab = [&]() {
    mbar_arrive(&empty[stage]);
    if (tid == 0) {
      mbar_wait(&empty[stage], phase);
      issue(seq + kMlpStages);
    }
    ++seq;
    if (++stage == kMlpStages) {
      stage = 0;
      phase ^= 1;
    }
  };

  FUSED_CLOCKS;  // slots: 0 tiles, 1 prologue, 2 slab waits, 3 first products, 4 z, 5 second products, 6 epilogue, 7 whole tile
  for (int tile = blockIdx.x; tile * kFusedRows < M; tile += gridDim.x) {
    FUSED_TIC(t_tile);
    // the lane's coordinates, opaque to the compiler once a tile: it would
    // otherwise hoist every address derived from them out of the tile loop
    // and spill them
    int ltid = tid;
    asm volatile("" : "+r"(ltid));
    const int warp = (ltid % 128) >> 5, lane = ltid & 31, g = lane >> 2, t = lane & 3;
    const int row0 = tile * kFusedRows + 64 * wg;
    if (leader) bulk_wait_read<0>();  // the last tile's output stores have left the staging tiles (over u2)
    named_bar_sync(1 + wg, 128);
    // ---- h = q + ga * attn (kept), u = LN(h) * ea + eb, u2 = LN(u) (the A
    // operand); each warp takes its 16 rows four at a time (the reductions of
    // four rows overlap), reading the next four meanwhile; rows past M repeat
    // row M-1
    constexpr int R = kMlpLnRows;
    uint2 qc[R][NCH], ac[R][NCH];  // this step's raw rows
    int sc[R];
    auto fetch = [&](int rr, uint2 (&qd)[R][NCH], uint2 (&ad)[R][NCH], int (&sd)[R]) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int row = min(row0 + 16 * warp + rr + j, M - 1);
#pragma unroll
        for (int i = 0; i < NCH; ++i) {
          qd[j][i] = *reinterpret_cast<const uint2*>(q + (size_t)row * F + 4 * (lane + 32 * i));
          ad[j][i] = *reinterpret_cast<const uint2*>(att + (size_t)row * F + 4 * (lane + 32 * i));
        }
        sd[j] = seg_of(row, mode, seg);
      }
    };
    fetch(0, qc, ac, sc);
    // a rolled loop: fully unrolled, the compiler hoisted every row's reads
    // to the top and spilled
#pragma unroll 1
    for (int rr = 0; rr < 16; rr += R) {
      float v[R][kMaxChunks][4];
      unsigned prow[R];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int r = 16 * warp + rr + j;
        prow[j] = (unsigned)mod_row_of(min(row0 + r, M - 1), L, mode, sc[j], e1) * F;
#pragma unroll
        for (int i = 0; i < NCH; ++i) {
          const int f = 4 * (lane + 32 * i);
          const float4 g4 = *reinterpret_cast<const float4*>(ga + prow[j] + f);
          float qv[4], av[4];
          bf16x4_to_float(qc[j][i], qv);
          bf16x4_to_float(ac[j][i], av);
          v[j][i][0] = qv[0] + g4.x * av[0];
          v[j][i][1] = qv[1] + g4.y * av[1];
          v[j][i][2] = qv[2] + g4.z * av[2];
          v[j][i][3] = qv[3] + g4.w * av[3];
          sts_f4(h_s + swz_h_offset<F>(r, f), v[j][i][0], v[j][i][1], v[j][i][2], v[j][i][3]);
        }
      }
      // the next step's rows, read under this step's reductions
      if (rr + R < 16) fetch(rr + R, qc, ac, sc);
      warp_layernorm_rows<R>(v, NCH, F);
#pragma unroll
      for (int j = 0; j < R; ++j)
#pragma unroll
        for (int i = 0; i < NCH; ++i) {
          const int f = 4 * (lane + 32 * i);
          const float4 a4 = *reinterpret_cast<const float4*>(ea + prow[j] + f);
          const float4 b4 = *reinterpret_cast<const float4*>(eb + prow[j] + f);
          v[j][i][0] = v[j][i][0] * a4.x + b4.x;
          v[j][i][1] = v[j][i][1] * a4.y + b4.y;
          v[j][i][2] = v[j][i][2] * a4.z + b4.z;
          v[j][i][3] = v[j][i][3] * a4.w + b4.w;
        }
      warp_layernorm_rows<R>(v, NCH, F);  // u2 = LN(u)
#pragma unroll
      for (int j = 0; j < R; ++j)
#pragma unroll
        for (int i = 0; i < NCH; ++i)
          sts_bf16x4(u_s + swz_a_offset(16 * warp + rr + j, 4 * (lane + 32 * i)), v[j][i]);
    }
    fence_proxy_async();
    named_bar_sync(1 + wg, 128);  // u2 and h are complete
    FUSED_TOC(1, t_tile);

    // ---- z = lrelu(u2 W0 + b0), kept as bf16 A fragments of the second product
    uint32_t z[FH / 4];
#pragma unroll
    for (int nc = 0; nc < NC0; ++nc) {
      float acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS0; ++ks) {
        FUSED_TIC(t_wait);
        const uint32_t slab = next_slab();
        FUSED_TOC(2, t_wait);
        FUSED_TIC(t_mma);
        uint64_t da[4], db[4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          da[kk] = gmma_desc(u_s + ks * 8192 + 32 * kk, 1024, 1);
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
        release_slab();
      }
      FUSED_TIC(t_z);
      // bias, lrelu and the cast in registers; the accumulator's (row,
      // column) layout is the A fragment's: two adjacent 8-wide slices per
      // 16-deep k-step
#pragma unroll
      for (int kk = 0; kk < kFusedBN / 16; ++kk) {
        const float4 bb = *reinterpret_cast<const float4*>(b0 + nc * kFusedBN + 16 * kk + 2 * t);
        const float2 bc = *reinterpret_cast<const float2*>(b0 + nc * kFusedBN + 16 * kk + 8 + 2 * t);
        uint32_t* zk = z + 4 * (nc * (kFusedBN / 16) + kk);
        zk[0] = pack_bf16(lrelu(acc[8 * kk] + bb.x), lrelu(acc[8 * kk + 1] + bb.y));
        zk[1] = pack_bf16(lrelu(acc[8 * kk + 2] + bb.x), lrelu(acc[8 * kk + 3] + bb.y));
        zk[2] = pack_bf16(lrelu(acc[8 * kk + 4] + bc.x), lrelu(acc[8 * kk + 5] + bc.y));
        zk[3] = pack_bf16(lrelu(acc[8 * kk + 6] + bc.x), lrelu(acc[8 * kk + 7] + bc.y));
      }
      FUSED_TOC(4, t_z);
    }

    // ---- out = h + gm * lrelu(z W1 + b1), 64 columns at a time
    const int r0 = 16 * warp + g, r1 = r0 + 8;
    // (M * F < 2^31: the C entry point refuses larger inputs)
    const unsigned pr0 = (unsigned)mod_row(min(row0 + r0, M - 1), L, mode, seg, e1) * F;
    const unsigned pr1 = (unsigned)mod_row(min(row0 + r1, M - 1), L, mode, seg, e1) * F;
#pragma unroll
    for (int nc = 0; nc < NC1; ++nc) {
      const int n0 = nc * 64;
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS1; ++ks) {
        FUSED_TIC(t_wait);
        const uint32_t slab = next_slab();
        FUSED_TOC(2, t_wait);
        FUSED_TIC(t_mma);
        uint64_t db[8];
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {  // two 64-deep boxes, 16 deep a k-step
          db[kk] = gmma_desc(slab + (kk >> 2) * 8192 + 32 * (kk & 3), 1024, 1);
          asm volatile("" : "+l"(db[kk]));
        }
        fence_operand(acc);
        fence_operand(z);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) {
          const uint32_t* zk = z + 4 * (ks * 8 + kk);
          const uint32_t a[4] = {zk[0], zk[1], zk[2], zk[3]};
          wgmma_rs_m64n64k16_kmajor(acc, a, db[kk]);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_operand(acc);
        fence_operand(z);
        FUSED_TOC(5, t_mma);
        release_slab();
      }
      // epilogue: the gated residual into a 64 x 64 staging tile over u2 (one
      // per chunk), which one thread hands to the TMA (rows past M are not
      // written); the stores run on under the next products
      FUSED_TIC(t_epi);
      const uint32_t cb_s = u_s + nc * 8192;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = n0 + 8 * j + 2 * t;
        const float2 bb = *reinterpret_cast<const float2*>(b1 + c);
        const float2 h0 = lds_f2(h_s + swz_h_offset<F>(r0, c));
        const float2 h1 = lds_f2(h_s + swz_h_offset<F>(r1, c));
        const float2 m0 = *reinterpret_cast<const float2*>(gm + pr0 + c);
        const float2 m1 = *reinterpret_cast<const float2*>(gm + pr1 + c);
        sts_u32(cb_s + swz_c_offset(r0, j) + 4 * t,
                pack_bf16(h0.x + m0.x * lrelu(acc[4 * j] + bb.x), h0.y + m0.y * lrelu(acc[4 * j + 1] + bb.y)));
        sts_u32(cb_s + swz_c_offset(r1, j) + 4 * t,
                pack_bf16(h1.x + m1.x * lrelu(acc[4 * j + 2] + bb.x), h1.y + m1.y * lrelu(acc[4 * j + 3] + bb.y)));
      }
      fence_proxy_async();
      named_bar_sync(1 + wg, 128);  // the staging tile is complete (after the last chunk: h and u2 are free)
      if (leader) {
        tma_store_2d(&to, cb_s, n0, row0);
        bulk_commit();
      }
      FUSED_TOC(6, t_epi);
    }
    FUSED_TOC(7, t_tile);
    FUSED_TILE_DONE();
  }
  if (leader) bulk_wait<0>();  // the last stores have finished before the block's shared memory goes
  FUSED_CLOCKS_FLUSH();
}

// ---------------------------------------------------------------------------
// fp32: 64 rows a block, 4 warps, FMA tiles from shared memory
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
fused_mlp_f32_kernel(const float* __restrict__ q, const float* __restrict__ att, const float* __restrict__ ga,
                     const float* __restrict__ ea, const float* __restrict__ eb, const float* __restrict__ gm,
                     const float* __restrict__ w0 /* (Fh, F) */, const float* __restrict__ b0,
                     const float* __restrict__ w1 /* (F, Fh) */, const float* __restrict__ b1,
                     const int* __restrict__ seg, float* __restrict__ out, int M, int L, int F, int Fh, int mode,
                     int e1) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LDC = kTileN + 4;  // fp32 staging tile
  const int lda = F + 4;
  const int ldz = Fh + 4;
  float* As = reinterpret_cast<float*>(smem_raw);  // [64][F + pad]        u2
  float* Zs = As + kTileM * lda;                   // [64][Fh + pad]       z
  float* Ws = Zs + kTileM * ldz;                   // 2 x [64][128 + pad]  weight slabs
  float* Cs = As;                                  // [64][64 + 4], over As once As is dead

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
      prow[j] = mod_row(row, L, mode, seg, e1) * F;
#pragma unroll
      for (int i = 0; i < kMaxChunks; ++i)
        if (i < nch) {
          const int f = 4 * (lane + 32 * i);
          float qv[4], av[4];
          load4<float>(q + xoff + f, qv);
          load4<float>(att + xoff + f, av);
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
      float* ar = As + (16 * warp + rr + j) * lda;
#pragma unroll
      for (int i = 0; i < kMaxChunks; ++i)
        if (i < nch) store4<float>(ar + 4 * (lane + 32 * i), v[j][i]);
    }
  }

  // z = lrelu(u2 @ W0 + b0) -> Zs
  tile_gemm_chunks<float>(As, lda, w0, F, 0, Fh / kTileN, Ws, [&](int n0, const float(&acc)[32]) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      int r, c;
      TileMma<float>::coord(i, r, c);
      Zs[r * ldz + n0 + c] = lrelu(acc[i] + b0[n0 + c]);
    }
  });

  // out = h + gate_m * lrelu(z @ W1 + b1); As is dead from here on, Cs lies over it
  tile_gemm_chunks<float>(Zs, ldz, w1, Fh, 0, F / kTileN, Ws, [&](int n0, const float(&acc)[32]) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      int r, c;
      TileMma<float>::coord(i, r, c);
      Cs[r * LDC + c] = lrelu(acc[i] + b1[n0 + c]);
    }
    __syncthreads();
    for (int p = threadIdx.x; p < kTileM * (kTileN / 4); p += kThreads) {
      const int r = p / (kTileN / 4), c4 = 4 * (p % (kTileN / 4));
      const int row = row0 + r;
      if (row < M) {
        const size_t xoff = (size_t)row * F + n0 + c4;
        const size_t poff = mod_row(row, L, mode, seg, e1) * F + n0 + c4;
        float qv[4], av[4];
        load4<float>(q + xoff, qv);
        load4<float>(att + xoff, av);
        const float4 g4 = *reinterpret_cast<const float4*>(ga + poff);
        const float4 m4 = *reinterpret_cast<const float4*>(gm + poff);
        const float4 z4 = *reinterpret_cast<const float4*>(Cs + r * LDC + c4);
        const float o[4] = {(qv[0] + g4.x * av[0]) + m4.x * z4.x, (qv[1] + g4.y * av[1]) + m4.y * z4.y,
                            (qv[2] + g4.z * av[2]) + m4.z * z4.z, (qv[3] + g4.w * av[3]) + m4.w * z4.w};
        store4<float>(out + xoff, o);
      }
    }
    // Cs is written again only after the next chunk's products, behind two block syncs
  });
}

template <int F, int FH>
static int launch_mlp_bf16(const void* q, const void* att, const void* ga, const void* ea, const void* eb,
                           const void* gm, const void* w0, const void* b0, const void* w1, const void* b1,
                           const int* seg, void* out, int M, int L, int mode, int e1, int smem, cudaStream_t stream) {
  if (smem != mlp_smem_bytes<F>() || smem > 232448) return (int)cudaErrorInvalidValue;
  static int allowed = 0;
  const cudaError_t e = opt_in_once(fused_mlp_wgmma_kernel<F, FH>, smem, allowed);
  if (e != cudaSuccess) return (int)e;
  CUtensorMap tw0, tw1, to;
  if (!encode_matrix_bf16(&tw0, w0, FH, F, kFusedBN, kFusedBK) || !encode_matrix_bf16(&tw1, w1, F, FH, 64, kFusedBK) ||
      !encode_matrix_bf16(&to, out, M, F, 64, 64))
    return (int)cudaErrorInvalidValue;
  const int ntiles = (M + kFusedRows - 1) / kFusedRows;
  fused_mlp_wgmma_kernel<F, FH><<<ntiles < sm_count() ? ntiles : sm_count(), kMlpThreads, smem, stream>>>(
      tw0, tw1, to, static_cast<const bf16*>(q), static_cast<const bf16*>(att), static_cast<const float*>(ga),
      static_cast<const float*>(ea), static_cast<const float*>(eb), static_cast<const float*>(gm),
      static_cast<const float*>(b0), static_cast<const float*>(b1), seg, M, L, mode, e1);
  return (int)cudaGetLastError();
}

static int launch_mlp_f32(const void* q, const void* att, const void* ga, const void* ea, const void* eb,
                          const void* gm, const void* w0, const void* b0, const void* w1, const void* b1,
                          const int* seg, void* out, int M, int L, int F, int Fh, int mode, int e1, int smem,
                          cudaStream_t stream) {
  if (smem != mlp_f32_smem_bytes(F, Fh) || smem > 232448) return (int)cudaErrorInvalidValue;
  static int allowed = 0;
  const cudaError_t e = opt_in_once(fused_mlp_f32_kernel, smem, allowed);
  if (e != cudaSuccess) return (int)e;
  fused_mlp_f32_kernel<<<(M + kTileM - 1) / kTileM, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(att), static_cast<const float*>(ga),
      static_cast<const float*>(ea), static_cast<const float*>(eb), static_cast<const float*>(gm),
      static_cast<const float*>(w0), static_cast<const float*>(b0), static_cast<const float*>(w1),
      static_cast<const float*>(b1), seg, static_cast<float*>(out), M, L, F, Fh, mode, e1);
  return (int)cudaGetLastError();
}

}  // namespace srhep

// q, attn, out (M, F); ga, ea, eb, gm fp32 modulation rows: (B, F) (mode 0),
// (M, F) (mode 1) or per-segment tables (B, e1, F) with seg (M,) int32 (mode
// 2); w0 (Fh, F) and w1 (F, Fh) n-major; b0 (Fh), b1 (F) fp32.  smem: the
// wrapper's count of the block's shared memory, which must equal this
// layout's.  bf16: F, Fh in {128, 256}; fp32: F, Fh % 128 == 0, <= 1024.
// Returns cudaGetLastError().
extern "C" int srhep_fused_mlp(const void* q, const void* att, const void* ga, const void* ea, const void* eb,
                               const void* gm, const void* w0, const void* b0, const void* w1, const void* b1,
                               const void* seg, void* out, int M, int L, int F, int Fh, int mode, int e1, int smem,
                               int is_bf16, void* stream) {
  using namespace srhep;
  if (M <= 0 || L <= 0 || mode < kRowsPerBatch || mode > kRowsPerSegment || (long long)M * F >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (mode == kRowsPerSegment && (seg == nullptr || e1 < 1)) return (int)cudaErrorInvalidValue;
  const int* sg = static_cast<const int*>(seg);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
#define SRHEP_MLP_CASE(FF, HH)                                                                                       \
  if (F == FF && Fh == HH)                                                                                           \
    return launch_mlp_bf16<FF, HH>(q, att, ga, ea, eb, gm, w0, b0, w1, b1, sg, out, M, L, mode, e1, smem, s);
    SRHEP_MLP_CASE(128, 128)
    SRHEP_MLP_CASE(128, 256)
    SRHEP_MLP_CASE(256, 128)
    SRHEP_MLP_CASE(256, 256)
#undef SRHEP_MLP_CASE
    return (int)cudaErrorInvalidValue;
  }
  if (F % 128 != 0 || Fh % 128 != 0 || F > 1024 || Fh > 1024) return (int)cudaErrorInvalidValue;
  return launch_mlp_f32(q, att, ga, ea, eb, gm, w0, b0, w1, b1, sg, out, M, L, F, Fh, mode, e1, smem, s);
}

#ifdef SRHEP_FUSED_CLOCKS
// copies the stage counters to host (8 unsigned long longs) and clears them
extern "C" int srhep_read_mlp_clocks(void* host) {
  cudaMemcpyFromSymbol(host, srhep::srhep_fused_clocks, sizeof(srhep::srhep_fused_clocks));
  const unsigned long long z[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(srhep::srhep_fused_clocks, z, sizeof(z));
}
#endif
