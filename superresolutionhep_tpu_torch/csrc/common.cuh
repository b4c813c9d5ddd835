// Shared device helpers for the hand-written Hopper kernels of the PyTorch
// port: four-element loads and stores, the parameter-free LayerNorm of rows
// held across a warp, the modulation row of a cell in the fused kernels'
// three row forms, asynchronous weight-slab copies with a two-slab
// pipeline and a 64x64 block-level fp32 tile product from shared memory
// (register-tiled FMA loops, no tensor cores: TF32 would keep only ~3
// decimal digits, and the fp32 builds exist so that the kernels can be held
// tightly against their plain PyTorch versions; 32 accumulators per thread,
// coord() says which (row, col) of the tile accumulator i belongs to).  At
// the end, raw PTX for Hopper's asynchronous machinery (mbarrier, TMA loads
// and stores, wgmma, setmaxnreg, proxy fences), the tiles and helpers the
// bf16 attention forward and backward share, the tiling of the bf16 fused
// kernels and the host's tensor-map encoders, which the bf16 attention and
// fused kernels use.
#pragma once

#include <cuda.h>  // CUtensorMap (a type only: nothing here links against the driver)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace srhep {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 128;  // 4 warps per block, everywhere
constexpr int kTileM = 64;     // rows of a block tile
constexpr int kTileN = 64;     // output columns per pass
constexpr int kSlabK = 128;    // depth of one weight slab in shared memory
constexpr float kLnEps = 1e-5f;
constexpr float kLreluSlope = 0.01f;
constexpr float kNegInf = -1e30f;  // additive bias of a padded key, LSE of a dead query tile
constexpr float kBig = 1e30f;

// Element strides of a (B, L, H, D) attention operand whose head dim is contiguous.
struct Strides {
  long long b, l, h;
};

// ---- which keys a query attends: the attention kernels' two mask modes
// (template flag SEG), read through ids so that one code path serves both:
//  * padding masks (SEG = false; K1, K2, K5, K6): float 0/1 per query and per
//    key; every query has id 0, a valid key id 0 and a padded key kNoKey, so a
//    query attends every valid key;
//  * segment ids (SEG = true; K7, K8, K9): int32 per cell, PAD_SEG = -1 on
//    padding; a query attends the keys of its own segment, and padding cells
//    match each other, as in the TPU kernel's mask (segment equality alone).
// A key with id >= 0 is live; a cell past the end of the row gets kNoKey.
constexpr int kPadSeg = -1;
constexpr int kNoKey = -2;

template <bool SEG> __device__ __forceinline__ int key_id(const void* kmask, size_t i) {
  if (SEG) return static_cast<const int*>(kmask)[i];
  return static_cast<const float*>(kmask)[i] > 0.f ? 0 : kNoKey;
}
template <bool SEG> __device__ __forceinline__ int query_id(const void* qmask, size_t i) {
  return SEG ? static_cast<const int*>(qmask)[i] : 0;
}
template <bool SEG> __device__ __forceinline__ bool query_valid(const void* qmask, size_t i) {
  return SEG ? static_cast<const int*>(qmask)[i] >= 0 : static_cast<const float*>(qmask)[i] > 0.f;
}

// 16 bytes of padding per shared-memory row: consecutive rows then start 16
// bytes apart modulo 128, so 16-byte reads of 8 consecutive rows hit distinct banks.
template <typename T> struct Pad { static constexpr int value = 16 / (int)sizeof(T); };

__device__ __forceinline__ float lrelu(float x) { return x >= 0.f ? x : kLreluSlope * x; }

// The modulation row of cell `row` (of M = B * L) in the fused kernels' three
// forms (ops/fused_qkv.py): one row per batch row (B, F), one per cell
// (M, F), or per segment: a table (B, e1, F) and the cells' segment ids, an id
// outside [0, e1 - 1) (padding's -1) taking the table's last row, the zero
// modulation that the one-hot scatter gives such a cell.
constexpr int kRowsPerBatch = 0, kRowsPerCell = 1, kRowsPerSegment = 2;
// the same given the cell's segment id s (read by the caller, so that the
// read can be issued early; unused unless mode is kRowsPerSegment)
__device__ __forceinline__ size_t mod_row_of(int row, int L, int mode, int s, int e1) {
  if (mode == kRowsPerCell) return (size_t)row;
  const int b = row / L;
  if (mode == kRowsPerBatch) return (size_t)b;
  return (size_t)b * e1 + ((unsigned)s < (unsigned)(e1 - 1) ? s : e1 - 1);
}
__device__ __forceinline__ int seg_of(int row, int mode, const int* __restrict__ seg) {
  return mode == kRowsPerSegment ? seg[row] : 0;
}
__device__ __forceinline__ size_t mod_row(int row, int L, int mode, const int* __restrict__ seg, int e1) {
  return mod_row_of(row, L, mode, seg_of(row, mode, seg), e1);
}

// Four consecutive elements at a time: 16-byte fp32 accesses, and four bf16
// (8 bytes, as loaded) to fp32.
template <typename T> __device__ __forceinline__ void load4(const T* p, float (&o)[4]);
template <> __device__ __forceinline__ void load4<float>(const float* p, float (&o)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  o[0] = x.x; o[1] = x.y; o[2] = x.z; o[3] = x.w;
}
__device__ __forceinline__ void bf16x4_to_float(uint2 raw, float (&o)[4]) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}
template <typename T> __device__ __forceinline__ void store4(T* p, const float (&v)[4]);
template <> __device__ __forceinline__ void store4<float>(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// Parameter-free LayerNorm of R rows of F values, each spread over the warp in
// groups of four (lane holds elements 4*(lane + 32*i) .. +3, i < nch = F/128).
// Two passes in fp32, as the plain version: mean, centred values, mean of
// squares, rsqrt(var + eps).  The R rows are reduced in the same shuffle
// rounds, so their latencies overlap.
constexpr int kMaxChunks = 8;  // F <= 1024
template <int R>
__device__ __forceinline__ void warp_layernorm_rows(float (&v)[R][kMaxChunks][4], int nch, int F) {
  float s[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    s[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxChunks; ++i)
      if (i < nch) s[r] += (v[r][i][0] + v[r][i][1]) + (v[r][i][2] + v[r][i][3]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < R; ++r) s[r] += __shfl_xor_sync(0xffffffffu, s[r], o);
  float q[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float mu = s[r] / (float)F;
    q[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxChunks; ++i)
      if (i < nch) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[r][i][e] -= mu;
          q[r] += v[r][i][e] * v[r][i][e];
        }
      }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < R; ++r) q[r] += __shfl_xor_sync(0xffffffffu, q[r], o);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float rs = rsqrtf(q[r] / (float)F + kLnEps);
#pragma unroll
    for (int i = 0; i < kMaxChunks; ++i)
      if (i < nch) {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[r][i][e] *= rs;
      }
  }
}

// two floats as a bf16 pair in one 32-bit word
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x = lo in the low half
  return *reinterpret_cast<uint32_t*>(&p);
}

// acc(64x64) += As(64 x K, row stride lda) * Bs(64 x K, row stride ldb)^T,
// both in shared memory; Bs is "n-major": row n holds the K weights of
// output column n (the layout of a torch Linear weight).  fp32 only (the
// fused kernels' fp32 bodies); their bf16 bodies use wgmma.
template <typename T> struct TileMma;

template <> struct TileMma<float> {
  // thread (ty, tx) = (tid / 8, tid % 8) owns rows 4*ty + i, cols tx + 8*j
  static __device__ __forceinline__ void run(const float* As, int lda, const float* Bs, int ldb, int K,
                                             float (&acc)[32]) {
    const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
    for (int k = 0; k < K; k += 4) {
      float4 a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(As + (4 * ty + i) * lda + k);
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = *reinterpret_cast<const float4*>(Bs + (tx + 8 * j) * ldb + k);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float s = acc[8 * i + j];
          s = fmaf(a[i].x, b[j].x, s);
          s = fmaf(a[i].y, b[j].y, s);
          s = fmaf(a[i].z, b[j].z, s);
          s = fmaf(a[i].w, b[j].w, s);
          acc[8 * i + j] = s;
        }
    }
  }
  static __device__ __forceinline__ void coord(int i, int& r, int& c) {
    const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
    r = 4 * ty + (i >> 3);
    c = tx + 8 * (i & 7);
  }
};

// ---- asynchronous global -> shared copies (cp.async, 16 bytes each)
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gsrc) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gsrc));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying a 64 x kSlabK slab of an n-major weight W (row stride ldw_g
// elements) at (n0, k0) into shared memory Ws (row stride kSlabK + pad).
template <typename T>
__device__ __forceinline__ void load_weight_slab_async(T* Ws, const T* __restrict__ W, int ldw_g, int n0, int k0) {
  constexpr int VEC = 16 / (int)sizeof(T);
  constexpr int CPR = kSlabK / VEC;  // 16-byte pieces per row
  constexpr int LDS = kSlabK + Pad<T>::value;
  for (int c = threadIdx.x; c < kTileN * CPR; c += kThreads) {
    const int r = c / CPR, cc = c % CPR;
    cp_async16(Ws + r * LDS + cc * VEC, W + (size_t)(n0 + r) * ldw_g + k0 + cc * VEC);
  }
}

// For every 64-column chunk nc in [nc_begin, nc_end): acc(64x64) = As(64 x K) *
// W[64*nc .. 64*nc+63][0..K)^T, then epi(64*nc, acc).  W streams through two
// slab buffers in shared memory (Ws holds both): the copy of the next slab is
// in flight while the tensor cores work on the current one.  Every thread of
// the block must call this; epi may synchronise the block.
template <typename T, typename Epilogue>
__device__ __forceinline__ void tile_gemm_chunks(const T* As, int lda, const T* __restrict__ W, int K,
                                                 int nc_begin, int nc_end, T* Ws, Epilogue epi) {
  constexpr int LDS = kSlabK + Pad<T>::value;
  constexpr int SLAB = kTileN * LDS;
  const int KS = K / kSlabK;
  const int n_it = (nc_end - nc_begin) * KS;
  if (n_it <= 0) return;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  load_weight_slab_async<T>(Ws, W, K, nc_begin * kTileN, 0);
  cp_async_commit();
  for (int it = 0; it < n_it; ++it) {
    const int nc = nc_begin + it / KS, ks = it % KS;
    if (it + 1 < n_it) {
      load_weight_slab_async<T>(Ws + ((it + 1) & 1) * SLAB, W, K, (nc_begin + (it + 1) / KS) * kTileN,
                                ((it + 1) % KS) * kSlabK);
      cp_async_commit();
      cp_async_wait<1>();  // all but the copy just started have landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // slab `it` (and, first time, As) visible to every warp
    TileMma<T>::run(As + ks * kSlabK, lda, Ws + (it & 1) * SLAB, LDS, kSlabK, acc);
    __syncthreads();  // slab buffer free for the copy started next iteration
    if (ks == KS - 1) {
      epi(nc * kTileN, acc);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    }
  }
}


// ---------------------------------------------------------------------------
// Hopper (sm_90a): mbarriers, TMA, warpgroup MMA, register reallocation.
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
// makes initialised barriers visible to the async proxy (TMA) and to the block
__device__ __forceinline__ void fence_mbar_init() { asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory"); }
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// one arrival, and `bytes` more to come from the TMA before the phase can complete
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, unsigned parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}
// Wait until the barrier has left phase `parity`.  A wait that lasts ~4 s
// (2^33 cycles) can only be a protocol fault: trap, so that the launch
// fails with an error instead of hanging the card.
constexpr long long kWaitTrapCycles = 1LL << 33;
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > kWaitTrapCycles) __trap();
}

// Named barriers (0 is __syncthreads): `n` threads in all, some syncing
// (they wait), the rest arriving (they do not).
__device__ __forceinline__ void named_bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void named_bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// TMA: one box of a 4-d tiled tensor map into shared memory, completion
// reported to `bar` as transaction bytes.  The map must live in the kernel's
// parameter space (a __grid_constant__ argument).
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], "
      "[%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// TMA: one box of a 2-d tiled tensor map (c0 the inner coordinate)
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// TMA: a shared-memory tile into one box of a 2-d tiled tensor map (rows and
// columns past the map's end are not written); the stores of a thread form
// bulk groups: commit closes one, wait_read<N> returns once all but N groups
// have finished reading shared memory, wait<N> once they have finished
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
               ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
template <int N> __device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// makes this thread's ordinary shared-memory writes visible to the async
// proxy (wgmma reading an operand the threads wrote); a barrier follows
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// setmaxnreg: all four warps of a warpgroup execute it together
template <int R> __device__ __forceinline__ void warpgroup_reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R> __device__ __forceinline__ void warpgroup_reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// wgmma ordering: fence before a batch whose register operands other
// instructions wrote; commit closes a group; wait<N> leaves at most N groups
// in flight.  An accumulator or A fragment must not be touched between the
// issue and the wait: fence_operand pins it, so that the compiler neither
// reads it early nor reuses its registers while the tensor cores hold it.
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
template <int N> __device__ __forceinline__ void fence_operand(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N> __device__ __forceinline__ void fence_operand(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Shared-memory matrix descriptor of wgmma: start address, leading and stride
// byte offsets (16-byte units), swizzle (1 = 128 B, 2 = 64 B, 3 = 32 B).  For
// a tile of rows exactly one swizzle span wide, as the TMA writes it:
//  * K-major (rows hold the contraction dim): SBO = 8 rows, LBO unused; the
//    next 16-deep k-step starts 32 bytes further;
//  * MN-major (rows are the contraction dim, the row holds N): SBO = 8 rows
//    (the next 8 of the contraction), LBO unused while N is one span.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t saddr, uint32_t sbo_bytes, int swizzle) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(sbo_bytes >> 4) << 32) |
         ((uint64_t)swizzle << 62);
}

// D(64 x 64, fp32) (+)= A(64 x 16) * B(16 x 64), A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D(64 x 8, fp32) += A(64 x 16, bf16 pairs in registers) * B(16 x 8), B K-major in shared memory
__device__ __forceinline__ void wgmma_rs_m64n8k16(float (&d)[4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 16, fp32) += A(64 x 16, bf16 pairs in registers) * B(16 x 16), B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_m64n16k16(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 32, fp32) += A(64 x 16, bf16 pairs in registers) * B(16 x 32), B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_m64n32k16(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 64, fp32) += A(64 x 16, bf16 pairs in registers) * B(16 x 64), B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 64, fp32) += A(64 x 16, bf16 pairs in registers) * B(16 x 64), B K-major in shared memory
__device__ __forceinline__ void wgmma_rs_m64n64k16_kmajor(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D(64 x 128, fp32) (+)= A(64 x 16) * B(16 x 128), A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_m64n128k16(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D(64 x 128, fp32) = A(64 x 16) * B(16 x 128), A and B K-major in shared memory: D's old values are
// not read (write-only operands), so that D holds no registers before the product
__device__ __forceinline__ void wgmma_ss_m64n128k16_fresh(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]), "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]), "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]), "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

// ---------------------------------------------------------------------------
// The bf16 attention kernels (flash_attention.cu, flash_attention_bwd.cu): a
// 64-row tile of head dim D as the TMA writes it (rows of 2*D bytes, swizzled
// over that span, which is also the wgmma descriptors' layout), the O += P V
// product shape for each D, and the exponential.
// ---------------------------------------------------------------------------
template <int D> struct FwdTiles {
  static constexpr int kRowBytes = 2 * D;           // one bf16 row: also the swizzle span
  static constexpr int kTileBytes = 64 * kRowBytes; // a 64-row tile
  static constexpr int kSwizzle = D == 64 ? 1 : (D == 32 ? 2 : 3);  // wgmma layout: 128, 64, 32 B
};

// byte offset of element (r, c) in a 64-row tile of FwdTiles<D>: the TMA's
// 128/64/32-byte swizzle XORs address bits 4.. with bits 7.. (the tile's base
// is aligned to 1024 bytes)
template <int D> __device__ __forceinline__ uint32_t swz_tile_offset(int r, int c) {
  const uint32_t off = (uint32_t)(r * 2 * D + 2 * c);
  return off ^ ((off >> 3) & (uint32_t)((D / 8 - 1) << 4));
}

template <int D> __device__ __forceinline__ void pv_mma(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 64) wgmma_rs_m64n64k16(o, a, db);
  else if constexpr (D == 32) wgmma_rs_m64n32k16(o, a, db);
  else wgmma_rs_m64n16k16(o, a, db);
}

// the A fragments of a (64 x 16k) x (16k x N) wgmma from a 64-row fp32
// accumulator tile of 2N columns (P of the forward's P V, P and dS of the
// backward): bf16 pairs, two adjacent 8-wide slices per 16-deep k-step
template <int N> __device__ __forceinline__ void pack_p(const float (&s)[N], uint32_t (&p)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

// 2^x on the special-function unit, subnormal results flushed to zero: the
// instruction exp2f compiles to, without its subnormal fix-up (a compare and
// two multiplies per element, for results below 2^-126 that the no-max clip
// never reaches and the robust softmax sums to nothing).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// TMA: a shared-memory tile into one box of a 4-d tiled tensor map (rows past
// the map's end are not written); a bulk group, as tma_store_2d
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0, int c1, int c2, int c3) {
  asm volatile("cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
               ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
               : "memory");
}

// ---------------------------------------------------------------------------
// The bf16 fused kernels (fused_qkv.cu, fused_mlp.cu): persistent blocks of
// kFusedNC consumer warpgroups of 64 rows each and two producer warps (one
// thread of the first issues the TMA loads of the weight slabs, one of the
// second those of activation tiles); the weights stream through a ring of
// [kFusedBN output columns][kFusedBK depth] slabs, 128-byte swizzled, the
// layout a K-major wgmma operand takes.  No setmaxnreg: ptxas allocated the
// consumers no more than the launch bound's 168 registers with it either
// (a block of ten warps puts three on an SM sub-partition: 16K / 96), and
// the bodies are written to fit that.
// ---------------------------------------------------------------------------
constexpr int kFusedNC = 2;                             // consumer warpgroups: 128-row tiles
constexpr int kFusedRows = 64 * kFusedNC;               // rows of a tile
constexpr int kFusedThreads = 128 * kFusedNC + 64;      // + two producer warps
constexpr int kFusedBN = 128;                           // output columns of one product chunk (wgmma N)
constexpr int kFusedBK = 64;                            // depth of a slab: 128 bytes of bf16, the swizzle span
constexpr int kFusedSlabBytes = kFusedBN * kFusedBK * 2;  // 16 KB

// Cycle counters of the bf16 fused kernels' stages, per consumer warpgroup
// and tile, compiled in only with -DSRHEP_FUSED_CLOCKS (tools/fused_variants.py
// builds that variant; the counters slow the kernels): slot 0 counts tiles,
// the others the cycles of one stage each, summed over tiles and warpgroups.
#ifdef SRHEP_FUSED_CLOCKS
__device__ unsigned long long srhep_fused_clocks[8];
#define FUSED_CLOCKS long long clk_[8] = {0, 0, 0, 0, 0, 0, 0, 0}
#define FUSED_TIC(v) const long long v = clock64()
#define FUSED_TOC(slot, v) clk_[slot] += clock64() - (v)
#define FUSED_TILE_DONE() clk_[0] += 1
#define FUSED_CLOCKS_FLUSH()                                                                          \
  if ((threadIdx.x & 127) == 0)                                                                       \
    for (int i_ = 0; i_ < 8; ++i_) atomicAdd(&srhep_fused_clocks[i_], (unsigned long long)clk_[i_])
#else
#define FUSED_CLOCKS
#define FUSED_TIC(v)
#define FUSED_TOC(slot, v)
#define FUSED_TILE_DONE()
#define FUSED_CLOCKS_FLUSH()
#endif

// shared-memory accesses by 32-bit address (a generic pointer takes two
// registers, which the bf16 fused MLP kernel's epilogue cannot spare)
__device__ __forceinline__ float2 lds_f2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr));
  return v;
}
__device__ __forceinline__ void sts_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
__device__ __forceinline__ void sts_u2(uint32_t addr, uint2 v) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(addr), "r"(v.x), "r"(v.y) : "memory");
}
__device__ __forceinline__ void sts_f4(uint32_t addr, float a, float b, float c, float d) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(a), "f"(b), "f"(c), "f"(d) : "memory");
}
// four floats as bf16 into 8 bytes of shared memory
__device__ __forceinline__ void sts_bf16x4(uint32_t addr, const float (&v)[4]) {
  sts_u2(addr, make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3])));
}

// byte offset of element (r, f) in a swizzled bf16 A tile of 64 rows: F/64
// panels of [64 rows][128 bytes], the 16-byte chunk index XORed with r % 8
__device__ __forceinline__ uint32_t swz_a_offset(int r, int f) {
  return (uint32_t)((f >> 6) * 8192 + r * 128 + ((((f & 63) >> 3) ^ (r & 7)) << 4) + ((f & 7) << 1));
}
// byte offset of 16-byte chunk c (of 16: 8 columns each) of row r in a
// [64][128] bf16 output staging tile: two TMA boxes of [64 rows][64 columns]
// in the 128-byte swizzle, as the TMA store reads them (the accumulator
// layout's row-pair writes fall into distinct banks)
__device__ __forceinline__ uint32_t swz_c_offset(int r, int c) {
  return (uint32_t)((c >> 3) * 8192 + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

// ---------------------------------------------------------------------------
// host: cuTensorMapEncodeTiled from the driver the runtime already loaded
// (the library needs no -lcuda)
// ---------------------------------------------------------------------------
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (rc == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A row-major (rows, cols) bf16 matrix as a 2-d tiled map with box
// (box_cols, box_rows): in the 128-byte swizzle (box_cols * 2 must be 128),
// or plain rows (swizzle128 false); boxes past the end read zeros
static inline bool encode_matrix_bf16(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows,
                                      int box_cols, bool swizzle128 = true) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 || (cols * 2) % 16 || (box_cols * 2) % 16 ||
      box_cols > 256 || box_rows > 256 || (swizzle128 && box_cols * 2 != 128))
    return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A (B, L, H, D) bf16 view with D contiguous as a tiled map over (D, L, H, B):
// byte strides of L, H and B, box (D, 64, 1, 1), swizzle = the row's 2*D
// bytes, rows past L read as zeros (and are not written by a store).
// ops/flash_attention.py::tensor_map_plan states the same plan (and its
// checks) in Python.
static inline bool encode_operand(CUtensorMap* map, const void* ptr, int D, int L, int H, int B, Strides st) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)L, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.l * 2, (cuuint64_t)st.h * 2, (cuuint64_t)st.b * 2};
  for (int i = 0; i < 3; ++i)
    if (strides[i] % 16 || strides[i] >= (1ull << 40)) return false;
  const cuuint32_t box[4] = {(cuuint32_t)D, 64, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swz = D == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                           : CU_TENSOR_MAP_SWIZZLE_32B;
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Rows of L 32-bit values, fp32 or int32 (row stride ld elements, a multiple
// of 4) as a 2-d tiled map with box (64, 1): one attention row's 64 values of
// a tile; values past L read as zeros
static inline bool encode_rows_32(CUtensorMap* map, const void* ptr, int L, int rows, int ld, bool is_int) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 || ld % 4 || ld < L) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)L, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {64, 1};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map, is_int ? CU_TENSOR_MAP_DATA_TYPE_INT32 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(ptr),
            dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// one opt-in per kernel to more than 48 KB of dynamic shared memory, on the
// first launch (which the wrappers make eagerly, never inside a graph capture)
template <typename K> static inline cudaError_t opt_in_once(K kernel, int smem, int& allowed) {
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) allowed = smem;
  return e;
}

// streaming multiprocessors of the current device (queried once)
static inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

}  // namespace srhep
