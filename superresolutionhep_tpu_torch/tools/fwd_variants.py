"""Build variants of the bf16 attention forward body (``csrc/flash_fwd.cuh``
with ``csrc/flash_attention.cu`` and ``csrc/attention_probes.cu``, which use
it) or of the backward (``csrc/flash_attention_bwd.cu``) with one construct
changed, by string edits in a temporary directory (the repository is not
touched; an edit goes to whichever of the sources holds its text), as
libraries of their own, all at once, and time the wrappers with each at
``chip_smoke.py``'s shapes.

    python3 superresolutionhep_tpu_torch/tools/fwd_variants.py [variant ...]
    python3 superresolutionhep_tpu_torch/tools/fwd_variants.py bwd [variant ...]
    python3 superresolutionhep_tpu_torch/tools/fwd_variants.py f32 [variant ...]

Run from the repository root on a machine with the card and nvcc.  Prints one
JSON line per variant: the ptxas serialisation warnings (C751x) and whether
anything spilled; forward: the device time (ms) of K1/K2 at (10, 2048, 4, 64)
with ragged masks, of K7 robust / no-max at the (8, 5120) packed batch and of
the probes on the body (K10 ``full``, K11 bf16 exp with the all-ones mask)
at (8, 8, 2048, 64) on their default tile and on 64-row tiles, K7 no-max's
and the probes' errors against their plain versions, and for ``clocks`` the consumer
warpgroups' cycles per 64-row tile by stage of the loop (from clock64
counters, which themselves slow the kernel by about a third); backward: the
device time of K5/K6 at (10, 2048, 4, 64) with ragged masks and of K8/K9 at
the (8, 5120) packed batch (each wrapper call with its band launch), and
each output's error against its plain version; f32: the fp32 tensor-core
kernels (``csrc/tf32_attention.cuh`` and its two users), the device time of
the forward (with LSE), dq and dk/dv at (32, 640, 4, 16) and (10, 2048, 4,
64) with ragged masks and at the (8, 5120, 4, 64) packed batch, dq also on
``chip_smoke.py``'s offset keys at (4, 2048, 4, 16), each
output's error against its plain version, for ``clocks`` the forward's and
dq's cycles a live block by stage, and the SASS opcode counts of the D = 16
forward, dq and dk/dv instantiations (``cuobjdump``).
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

_T0 = "const long long _t0 = clock64();"


def _tick(i):
    return f"if (lane == 0 && warp == 0) dbg[{i}] += clock64() - _t0;"


# the probes' softmax (csrc/attention_probes.cu): mode full's s - m, and the bf16 modes' P
_PROBE_SUB = ("      } else {  // kFull: s - m, exponentiated in pack\n        s[4 * j] -= mn0;\n        s[4 * j + 1] -= mn0;\n"
              "        s[4 * j + 2] -= mn1;\n        s[4 * j + 3] -= mn1;\n      }")
_PROBE_PACK = "p[i] = ex2_bf16x2(pack_bf16(s[2 * i], s[2 * i + 1]));"

# the loop stages the clock counters read, by slot of the debug array
CLOCK_SLOTS = {0: "q_wait", 1: "full_wait", 2: "turn_wait", 8: "issue", 3: "s_wait", 4: "softmax", 5: "pv_wait",
               9: "iteration"}

VARIANTS = {
    "base": [],
    "turn_after_softmax": [(
        "          pass_turn();\n          wgmma_wait<1>();\n          fence_operand(s);\n"
        "          Soft::tile(s, ids + ns * BK, t, qid0, qid1, m0, m1, l0, l1, al0, al1);\n",
        "          wgmma_wait<1>();\n          fence_operand(s);\n"
        "          Soft::tile(s, ids + ns * BK, t, qid0, qid1, m0, m1, l0, l1, al0, al1);\n"
        "          pass_turn();\n")],
    "no_turns": [("constexpr bool kPingPong = NC > 1;", "constexpr bool kPingPong = false;")],
    # the probes (modes full and K11 bf16 are timed; no_max is left broken):
    # the bf16 exponentials under the products (in the softmax, their words
    # kept in s and copied into P) instead of after the wait; or only the
    # rounding of s - m to bf16 pairs there; the row max as a chain
    "probe_exp_in_softmax": [
        (_PROBE_SUB, "      } else {\n"
         "        s[2 * j] = __uint_as_float(ex2_bf16x2(pack_bf16(s[4 * j] - mn0, s[4 * j + 1] - mn0)));\n"
         "        s[2 * j + 1] = __uint_as_float(ex2_bf16x2(pack_bf16(s[4 * j + 2] - mn1, s[4 * j + 3] - mn1)));\n      }"),
        (_PROBE_PACK, "p[i] = __float_as_uint(s[i]);")],
    "probe_cvt_in_softmax": [
        (_PROBE_SUB, "      } else {\n"
         "        s[2 * j] = __uint_as_float(pack_bf16(s[4 * j] - mn0, s[4 * j + 1] - mn0));\n"
         "        s[2 * j + 1] = __uint_as_float(pack_bf16(s[4 * j + 2] - mn1, s[4 * j + 3] - mn1));\n      }"),
        (_PROBE_PACK, "p[i] = ex2_bf16x2(__float_as_uint(s[i]));")],
    "probe_chain_max": [("    constexpr int NP = BK == 64 ? 8 : 2;", "    constexpr int NP = 1;")],
    # the bf16 modes' row sums on the CUDA cores (each p unpacked and added
    # after the exponential) instead of by the tensor cores beside P V
    "probe_rowsum_on_cuda_cores": [
        ("Soft::pack(s, p);", "Soft::pack(s, p, l0, l1);"),
        ("static __device__ __forceinline__ void pack(const float (&s)[kBK / 2], uint32_t (&p)[kBK / 4]) {",
         "static __device__ __forceinline__ void pack(const float (&s)[kBK / 2], uint32_t (&p)[kBK / 4], float&, float&) {"),
        ("kRowSum = MODE == kNoMax || MODE == kFull;", "kRowSum = false;"),
        ("    if (MODE == kFp32Exp) {\n      l0 = l0 * al0 + ps0;\n      l1 = l1 * al1 + ps1;\n    }",
         "    if (MODE == kFp32Exp) {\n      l0 = l0 * al0 + ps0;\n      l1 = l1 * al1 + ps1;\n    } else {\n"
         "      l0 *= al0;\n      l1 *= al1;\n    }"),
        ("  static __device__ __forceinline__ void pack(const float (&s)[BK / 2], uint32_t (&p)[BK / 4]) {",
         "  static __device__ __forceinline__ void pack(const float (&s)[BK / 2], uint32_t (&p)[BK / 4], float& l0,\n"
         "                                              float& l1) {"),
        ("      for (int i = 0; i < BK / 4; ++i) p[i] = ex2_bf16x2(pack_bf16(s[2 * i], s[2 * i + 1]));",
         "      for (int i = 0; i < BK / 4; ++i) {\n        p[i] = ex2_bf16x2(pack_bf16(s[2 * i], s[2 * i + 1]));\n"
         "        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&p[i]));\n"
         "        if (i & 1) l1 += f.x + f.y;\n        else l0 += f.x + f.y;\n      }")],
    "stages_3": [("{ return NC == 1 ? 3 : 5; }", "{ return 3; }")],
    "lookahead_1": [("constexpr int kLookahead = 4;", "constexpr int kLookahead = 1;")],
    "clocks": [
        ('#include "common.cuh"\n\nnamespace srhep {\n',
         '#include "common.cuh"\n\nstatic __device__ unsigned long long srhep_clocks[16];\nnamespace srhep {\n'),
        ("    mbar_wait(qfull, 0);\n    int stage = 0;",
         "    long long dbg[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};\n    const long long _tb = clock64();\n"
         "    { " + _T0 + " mbar_wait(qfull, 0); " + _tick(0) + " }\n    int stage = 0;"),
        ("          mbar_wait(&full[ns], nph);\n          if (tile[ns] < 0) break;",
         "          { " + _T0 + " mbar_wait(&full[ns], nph); " + _tick(1) + " }\n          if (tile[ns] < 0) break;\n"
         "          dbg[7] += 1;\n          const long long _ti = clock64();"),
        ("          my_turn();\n          wgmma_fence();\n          issue_qk<D, BK>(s, dq);",
         "          { " + _T0 + " my_turn(); " + _tick(2) + " }\n          const long long _tis = clock64();\n"
         "          wgmma_fence();\n          issue_qk<D, BK>(s, dq);"),
        ("          pass_turn();\n          wgmma_wait<1>();\n          fence_operand(s);\n"
         "          Soft::tile(s, ids + ns * BK, t, qid0, qid1, m0, m1, l0, l1, al0, al1);\n"
         "          wgmma_wait<0>();",
         "          pass_turn();\n          if (lane == 0 && warp == 0) dbg[8] += clock64() - _tis;\n"
         "          { " + _T0 + " wgmma_wait<1>(); " + _tick(3) + " }\n          fence_operand(s);\n"
         "          { " + _T0 + " Soft::tile(s, ids + ns * BK, t, qid0, qid1, m0, m1, l0, l1, al0, al1); "
         + _tick(4) + " }\n          { " + _T0 + " wgmma_wait<0>(); " + _tick(5) + " }"),
        ("          Soft::pack(s, p);\n          stage = ns;",
         "          Soft::pack(s, p);\n          if (lane == 0 && warp == 0) dbg[9] += clock64() - _ti;\n"
         "          stage = ns;"),
        ("    if (kPingPong && wg == 0) named_bar_sync(1, 256);\n",
         "    if (kPingPong && wg == 0) named_bar_sync(1, 256);\n    if (lane == 0 && warp == 0) {\n"
         "      dbg[6] = clock64() - _tb;\n"
         "      for (int i = 0; i < 10; ++i) atomicAdd(&srhep_clocks[i], (unsigned long long)dbg[i]);\n"
         "      atomicAdd(&srhep_clocks[10], 1ull);\n    }\n"),
        ('extern "C" int srhep_packed_band(',
         'extern "C" int srhep_read_clocks(void* host) {\n'
         "  cudaMemcpyFromSymbol(host, srhep_clocks, sizeof(srhep_clocks));\n"
         "  unsigned long long z[16] = {0};\n"
         "  return (int)cudaMemcpyToSymbol(srhep_clocks, z, sizeof(z));\n}\n"
         'extern "C" int srhep_packed_band('),
        ('extern "C" int srhep_probe_variant(',  # the probes' counters live in their own source's copy
         'extern "C" int srhep_read_probe_clocks(void* host) {\n'
         "  cudaMemcpyFromSymbol(host, srhep_clocks, sizeof(srhep_clocks));\n"
         "  unsigned long long z[16] = {0};\n"
         "  return (int)cudaMemcpyToSymbol(srhep_clocks, z, sizeof(z));\n}\n"
         'extern "C" int srhep_probe_variant('),
    ],
}


# variants of the backward source
BWD_VARIANTS = {
    "base": [],
    # the ping-pong of the two consumer warpgroups off
    "no_turns": [("constexpr bool kBwdTurns = true;", "constexpr bool kBwdTurns = false;")],
    # the elementwise part no longer under the previous tile's products: wait
    # for every product of the step before it (dq and dk/dv loops)
    "no_overlap": [("      wgmma_wait<1>();\n      fence_operand(s);\n      fence_operand(dp);\n      dkv_tile_math",
                    "      wgmma_wait<0>();\n      fence_operand(s);\n      fence_operand(dp);\n      dkv_tile_math"),
                   ("      wgmma_wait<1>();\n      fence_operand(s);\n      fence_operand(dp);\n      dq_tile_math",
                    "      wgmma_wait<0>();\n      fence_operand(s);\n      fence_operand(dp);\n      dq_tile_math")],
    # dk/dv: the feeder's refill after the step's waits instead of under its products
    "fill_late": [("      turn.pass();\n      if (tid == 0) feed.fill();\n      wgmma_wait<1>();", "      turn.pass();\n      wgmma_wait<1>();"),
                  ("      mbar_arrive(&empty[stage]);\n      pack_p(s, pp);",
                   "      mbar_arrive(&empty[stage]);\n      if (tid == 0) feed.fill();\n      pack_p(s, pp);")],
}


# the fp32 kernels on the tensor cores (csrc/tf32_attention.cuh, flash_attention.cu, flash_attention_bwd.cu)
_RNA = "__device__ __forceinline__ uint32_t tf32_rna(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }"
_STAGES = "  static constexpr int kStages = 2;\n"
# dq's clock64 counters (clocks variant): slots of the debug array, cycles a live block's thread 0 spends
DQ_CLOCK_SLOTS = {0: "prologue", 1: "wait_barrier_issue", 2: "s_dp", 3: "elementwise", 4: "dq_products",
                  5: "epilogue"}
_DQ_CLOCKS = [
    ("constexpr int kDqTerms = 3;",
     "static __device__ unsigned long long srhep_dq_clocks[16];\n"
     "#define DQ_CP(slot) { const long long _n = clock64(); dbg[slot] += _n - _tp; _tp = _n; }\n"
     "constexpr int kDqTerms = 3;"),
    ("  const int r0 = blockIdx.x * kF32Rows + warp * 16 + gq, r1 = r0 + 8;  // this thread's query rows\n",
     "  const int r0 = blockIdx.x * kF32Rows + warp * 16 + gq, r1 = r0 + 8;  // this thread's query rows\n"
     "  const long long _tb = clock64();\n  long long _tp = _tb;\n  long long dbg[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"),
    ("      ids_in_place<SEG, true>(kid, cur * kF32Tile, Lk);\n",
     "      if (i == 0) DQ_CP(0);\n      ids_in_place<SEG, true>(kid, cur * kF32Tile, Lk);\n"),
    ("        // ---- S = Q K^T and dP = G V^T: 16 queries", "        DQ_CP(1);\n        // ---- S = Q K^T and dP = G V^T: 16 queries"),
    ("        // ---- P = exp2(min(s - lse, 0)) on attended pairs", "        DQ_CP(2);\n        // ---- P = exp2(min(s - lse, 0)) on attended pairs"),
    ("        // ---- dQ += dS K: dS's accumulator", "        DQ_CP(3);\n        // ---- dQ += dS K: dS's accumulator"),
    ("            add_frag(dqa[nt], t);\n          }\n        }\n      }\n      tq_.push(nxt);\n",
     "            add_frag(dqa[nt], t);\n          }\n        }\n        DQ_CP(4);\n      }\n      dbg[7] += 1;\n"
     "      tq_.push(nxt);\n"),
    ("make_float2(dqa[nt][2], dqa[nt][3]) : make_float2(0.f, 0.f);\n  }\n}\n",
     "make_float2(dqa[nt][2], dqa[nt][3]) : make_float2(0.f, 0.f);\n  }\n  DQ_CP(5);\n"
     "  if (threadIdx.x == 0 && ids.x <= ids.y) {\n"
     "    for (int i = 0; i < 8; ++i) atomicAdd(&srhep_dq_clocks[i], (unsigned long long)dbg[i]);\n"
     "    atomicAdd(&srhep_dq_clocks[10], (unsigned long long)(clock64() - _tb));\n  }\n"
     "  if (threadIdx.x == 0) atomicAdd(&srhep_dq_clocks[ids.x > ids.y ? 9 : 8], 1ull);\n}\n"),
    ("// launch: the bf16 kernels by tensor maps",
     "}  // namespace srhep\n"
     'extern "C" int srhep_read_dq_clocks(void* host) {\n'
     "  cudaMemcpyFromSymbol(host, srhep::srhep_dq_clocks, sizeof(srhep::srhep_dq_clocks));\n"
     "  unsigned long long z[16] = {0};\n  return (int)cudaMemcpyToSymbol(srhep::srhep_dq_clocks, z, sizeof(z));\n}\n"
     "namespace srhep {\n// launch: the bf16 kernels by tensor maps"),
]
F32_VARIANTS = {
    "base": [],
    # single TF32 products: what the two lo terms cost
    "terms1": [("constexpr int kFwdTerms = 3;", "constexpr int kFwdTerms = 1;"),
               ("constexpr int kDkvTerms = 3;", "constexpr int kDkvTerms = 1;"),
               ("constexpr int kDqTerms = 3;", "constexpr int kDqTerms = 1;")],
    # the PTX rounding instruction instead of the two integer instructions
    "cvt_rna": [(_RNA, "__device__ __forceinline__ uint32_t tf32_rna(float x) {\n  uint32_t r;\n"
                       "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(r) : \"f\"(x));\n  return r;\n}")],
    # a two-stage ring at every head dim
    # a three-stage ring in both kernels
    "stages3": [(_STAGES, "  static constexpr int kStages = 3;"),
                ("  static constexpr int kStages = 2;  // ring depth: deeper rings gained nothing (PERF.md)",
                 "  static constexpr int kStages = 3;")],
    # clock64 counters (every block's thread 0) of the forward: cycles to the ring, in the loop, after it;
    # of dq: to the ring, then per stage of the loop (DQ_CLOCK_SLOTS), after it
    "clocks": [
        ('#include "tf32_attention.cuh"\n',
         '#include "tf32_attention.cuh"\nstatic __device__ unsigned long long srhep_f32_clocks[16];\n'
         "#define F32_CP(slot) { const long long _n = clock64(); dbg[slot] += _n - _tp; _tp = _n; }\n"),
        ("  const bool in0 = r0 < Lq, in1 = r1 < Lq;\n",
         "  const bool in0 = r0 < Lq, in1 = r1 < Lq;\n  const long long _tb = clock64();\n  long long _tp = _tb;\n"
         "  long long dbg[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"),
        ("    // the ring: NS stages; tile i in stage i % NS.", "    F32_CP(0);\n    // the ring: NS stages; tile i in stage i % NS."),
        ("      tq_.push(nxt);\n    }\n    cp_async_wait<0>();\n  }\n\n  // ---- epilogue: row sums",
         "      dbg[7] += 1;\n      tq_.push(nxt);\n    }\n    cp_async_wait<0>();\n  }\n\n  // ---- epilogue: row sums"),
        ("    cp_async_wait<0>();\n  }\n\n  // ---- epilogue: row sums",
         "    F32_CP(1);\n    cp_async_wait<0>();\n  }\n\n  // ---- epilogue: row sums"),
        ("    if (in1) lp[r1] = dead ? kNegInf : m1 + log2f(den1);\n  }\n}",
         "    if (in1) lp[r1] = dead ? kNegInf : m1 + log2f(den1);\n  }\n  F32_CP(2);\n"
         "  if (threadIdx.x == 0) {\n    for (int i = 0; i < 8; ++i) atomicAdd(&srhep_f32_clocks[i], (unsigned long long)dbg[i]);\n"
         "    atomicAdd(&srhep_f32_clocks[dead ? 9 : 8], 1ull);\n"
         "    if (!dead) atomicAdd(&srhep_f32_clocks[10], (unsigned long long)(clock64() - _tb));\n  }\n}"),
        ("// The band table of a packed batch (K7's bf16 kernel)",
         'extern "C" int srhep_read_f32_clocks(void* host) {\n'
         "  cudaMemcpyFromSymbol(host, srhep_f32_clocks, sizeof(srhep_f32_clocks));\n"
         "  unsigned long long z[16] = {0};\n  return (int)cudaMemcpyToSymbol(srhep_f32_clocks, z, sizeof(z));\n}\n\n"
         "// The band table of a packed batch (K7's bf16 kernel)"),
        *_DQ_CLOCKS],
    # dq: four blocks an SM at D = 16 (at most 128 registers a thread)
    "dq_min_blocks4": [("__launch_bounds__(kThreads)\nflash_bwd_dq_f32_kernel(",
                        "__launch_bounds__(kThreads, D == 16 ? 4 : 1)\nflash_bwd_dq_f32_kernel(")],
    # dq: Q's and G's fragments raw at D = 16 too, split per tile
    "dq_own_raw": [("template <int D> __host__ __device__ constexpr bool dq_own_split() { return D == 16; }",
                    "template <int D> __host__ __device__ constexpr bool dq_own_split() { return false; }")],
    # dq: dQ summed as one chain of mma.sync (no step summed apart)
    "dq_one_chain": [("            mma_split<kDqTerms>(t, dh, dlo, bh0, bh1, bl0, bl1);",
                      "            mma_split<kDqTerms>(dqa[nt], dh, dlo, bh0, bh1, bl0, bl1);")],
    # dq: a key tile in two halves of 32 keys at every head dim (fewer registers)
    "dq_halves": [("  constexpr int NJS = D == 64 ? NJ / 2 : NJ;\n  constexpr int NS = T::kStages;\n  extern",
                   "  constexpr int NJS = NJ / 2;\n  constexpr int NS = T::kStages;\n  extern")],
    # more blocks an SM at D = 16 (fewer registers a thread)
    "fwd_min_blocks": [("__launch_bounds__(kThreads)\nflash_fwd_f32_kernel(",
                        "__launch_bounds__(kThreads, D == 16 ? 4 : 1)\nflash_fwd_f32_kernel(")],
}


def _build(files, compiled, variants, names, kernels, extra_sources=()):
    """Start one nvcc per variant: the edits go into the csrc/ ``files`` that
    hold their text, the variant's copies of ``files`` are written to a
    directory of its own (so that a .cu there includes the edited header),
    and its ``compiled`` sources, with ``extra_sources`` as they are, make one
    library; returns {name: (process, directory)}."""
    srcs = {f: (kernels.CSRC / f).read_text() for f in files}
    work = tempfile.mkdtemp(prefix="srhep_variants_")
    procs = {}
    for name in names:
        texts = dict(srcs)
        for old, new in variants[name]:
            holder = next((f for f, t in texts.items() if old in t), None)
            if holder is None:
                raise SystemExit(f"fwd_variants: {name}: no source holds {old[:60]!r}")
            texts[holder] = texts[holder].replace(old, new)
        d = os.path.join(work, name)
        os.makedirs(d)
        for f, text in texts.items():
            with open(os.path.join(d, f), "w") as fh:
                fh.write(text)
        cmd = ["/usr/local/cuda/bin/nvcc", *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I", str(kernels.CSRC),
               *(os.path.join(d, c) for c in compiled), *(str(kernels.CSRC / x) for x in extra_sources),
               "-o", os.path.join(d, "lib.so")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), d)
    return procs


def _build_line(name, p):
    """A variant's line so far: built, ptxas's serialisation warnings and
    whether anything spilled (printed at once, with the log, if the build
    failed)."""
    log = p.communicate()[0]
    line = {"variant": name, "built": p.returncode == 0,
            "serialised": sorted(set(re.findall(r"\((C751\d)\)", log))),
            "spills": any(re.search(r"[1-9]\d* bytes spill", x) for x in log.splitlines())}
    if p.returncode:
        print(json.dumps({**line, "log": log[-2000:]}), flush=True)
    return line


def _load(lib_path, kernels, fns):
    lib = ctypes.CDLL(lib_path)
    for fn in fns:
        getattr(lib, fn).argtypes = kernels._SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    kernels._lib = lib
    return lib


def main_bwd(names):
    import torch

    import chip_smoke as cs
    from superresolutionhep_tpu_torch.ops import flash_attention as fa
    from superresolutionhep_tpu_torch.ops import flash_packed as fp
    from superresolutionhep_tpu_torch.ops import kernels
    from superresolutionhep_tpu_torch.scripts.common import graph_ms

    names = names or list(BWD_VARIANTS)
    procs = _build(("flash_attention_bwd.cu",), ("flash_attention_bwd.cu",), BWD_VARIANTS, names, kernels,
                   extra_sources=("flash_attention.cu",))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    H, D = 4, 64
    kernels.library()  # the shipped forward makes the inputs (out, lse)

    def inputs(B, L, seg=None):
        qkv = torch.randn(B, L, 3, H, D, generator=g, device=dev)
        qkv[:, :, 0] *= (1.0 / D ** 0.5) * fa.LOG2E * 2.0
        qkv = qkv.to(torch.bfloat16)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if seg is None:
            valid, _ = cs.ragged_valid(B, L, dev)
            m = valid.float().contiguous()
            out, lse = fa._flash_fwd_cuda(q, k, v, m, m, nomax=False, with_lse=True)
            keep = valid
        else:
            out, lse = fp._packed_fwd_cuda(q, k, v, seg, nomax=False, with_lse=True)
            keep = seg >= 0
        gr = torch.randn(B, L, H, D, generator=g, device=dev).to(torch.bfloat16) * keep[:, :, None, None]
        dl = (out.float() * gr.float()).sum(-1).transpose(1, 2).contiguous()
        hf = fa._heads_first(q, k, v, gr)
        if seg is None:
            return (q, k, v, gr, lse, dl, m, m), (*hf, lse, dl, m[:, None])
        return (q, k, v, gr, lse, dl, seg), (*hf, lse, dl, seg)

    a5, r5 = inputs(10, 2048)
    _, seg_np, _ = cs.packed_layout()
    seg = torch.from_numpy(seg_np).to(dev)
    a8, r8 = inputs(seg.shape[0], seg.shape[1], seg)
    refs = {"k5": (fa._ref_flash_bwd_dq(*r5),), "k6": fa._ref_flash_bwd_dkv(*r5),
            "k8": (fp._ref_packed_bwd_dq(*r8),), "k9": fp._ref_packed_bwd_dkv(*r8)}
    calls = {"k5": lambda: fa._flash_bwd_dq_cuda(*a5), "k6": lambda: fa._flash_bwd_dkv_cuda(*a5),
             "k8": lambda: fp._packed_bwd_dq_cuda(*a8), "k9": lambda: fp._packed_bwd_dkv_cuda(*a8),
             # the other tile height: 64-row blocks, two an SM
             "k5_rows64": lambda: fa._flash_bwd_dq_cuda(*a5, block_rows=64),
             "k6_rows64": lambda: fa._flash_bwd_dkv_cuda(*a5, block_rows=64),
             "k8_rows64": lambda: fp._packed_bwd_dq_cuda(*a8, block_rows=64),
             "k9_rows64": lambda: fp._packed_bwd_dkv_cuda(*a8, block_rows=64)}
    for k in ("k5", "k6", "k8", "k9"):
        refs[k + "_rows64"] = refs[k]
    fns = ("srhep_flash_bwd_dq", "srhep_flash_bwd_dkv", "srhep_packed_bwd_dq", "srhep_packed_bwd_dkv",
           "srhep_packed_band")
    for name, (p, d) in procs.items():
        line = _build_line(name, p)
        if not line["built"]:
            continue
        _load(os.path.join(d, "lib.so"), kernels, fns)
        line["ms"] = {k: graph_ms(fn, 20, chain=8) for k, fn in calls.items()}
        line["max_rel_err"] = {}
        for k, fn in calls.items():
            got = fn()
            got = got if isinstance(got, tuple) else (got,)
            line["max_rel_err"][k] = max(
                ((a.float() - b.permute(0, 2, 1, 3).float()).abs().max() / b.float().abs().max()).item()
                for a, b in zip(got, refs[k]))
        print(json.dumps(line), flush=True)


def _sass_counts(lib_path, pattern):
    """Opcode counts of the SASS of the first function matching ``pattern``."""
    out = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", lib_path], capture_output=True, text=True).stdout
    counts, inside = {}, False
    for line in out.splitlines():
        if "Function :" in line:
            if inside:
                break
            inside = re.search(pattern, line) is not None
        elif inside:
            m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
            if m:
                counts[m.group(1)] = counts.get(m.group(1), 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def main_f32(names):
    import torch

    import chip_smoke as cs
    from superresolutionhep_tpu_torch.ops import flash_attention as fa
    from superresolutionhep_tpu_torch.ops import flash_packed as fp
    from superresolutionhep_tpu_torch.ops import kernels
    from superresolutionhep_tpu_torch.scripts.common import graph_ms

    names = names or list(F32_VARIANTS)
    srcs = ("flash_attention.cu", "flash_attention_bwd.cu")
    procs = _build(("tf32_attention.cuh", *srcs), srcs, F32_VARIANTS, names, kernels)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    H = 4
    _, seg_np, _ = cs.packed_layout()
    seg = torch.from_numpy(seg_np).to(dev)
    shapes = {"d16": (32, 640, 16, None), "d64": (10, 2048, 64, None), "packed": (8, 5120, 64, seg)}
    inputs = {}
    for key, (B, L, D, sg) in shapes.items():
        qkv = torch.randn(B, L, 3, H, D, generator=g, device=dev)
        qkv[:, :, 0] *= (1.0 / D ** 0.5) * fa.LOG2E * 2.0
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        hf = fa._heads_first(q, k, v)
        if sg is None:
            valid, _ = cs.ragged_valid(B, L, dev)
            m = valid.float().contiguous()
            out, lse = fa._ref_attention_base2(*hf, m[:, None], m[:, None], "max", with_lse=True)
            gr = torch.randn(B, L, H, D, generator=g, device=dev) * m[:, :, None, None]
            dl = (out.permute(0, 2, 1, 3) * gr).sum(-1).transpose(1, 2).contiguous()
            ref_args = (*hf, gr.permute(0, 2, 1, 3), lse, dl, m[:, None])
            inputs[key] = {"fwd": (lambda q=q, k=k, v=v, m=m: fa._flash_fwd_cuda(q, k, v, m, m, nomax=False,
                                                                                   with_lse=True)),
                           "dq": (lambda a=(q, k, v, gr, lse, dl, m, m): fa._flash_bwd_dq_cuda(*a)),
                           "dkv": (lambda a=(q, k, v, gr, lse, dl, m, m): fa._flash_bwd_dkv_cuda(*a)),
                           "ref_fwd": (out, lse), "ref_dq": (fa._ref_flash_bwd_dq(*ref_args),),
                           "ref_dkv": fa._ref_flash_bwd_dkv(*ref_args)}
        else:
            out, lse = fp._ref_packed_fwd(*hf, sg, "max", with_lse=True)
            gr = torch.randn(B, L, H, D, generator=g, device=dev) * (sg >= 0)[:, :, None, None]
            dl = (out.permute(0, 2, 1, 3) * gr).sum(-1).transpose(1, 2).contiguous()
            ref_args = (*hf, gr.permute(0, 2, 1, 3), lse, dl, sg)
            inputs[key] = {"fwd": (lambda q=q, k=k, v=v: fp._packed_fwd_cuda(q, k, v, sg, nomax=False, with_lse=True)),
                           "dq": (lambda a=(q, k, v, gr, lse, dl, sg): fp._packed_bwd_dq_cuda(*a)),
                           "dkv": (lambda a=(q, k, v, gr, lse, dl, sg): fp._packed_bwd_dkv_cuda(*a)),
                           "ref_fwd": (out, lse), "ref_dq": (fp._ref_packed_bwd_dq(*ref_args),),
                           "ref_dkv": fp._ref_packed_bwd_dkv(*ref_args)}
    # dq on chip_smoke.py's offset keys (fp32_tile_cases): head-dim column 0 of every key 100 times its
    # spread, 0 in every query; dQ's running sums along it ~100x dQ
    B, L, D = 4, 2048, 16
    sd = (2.9 / D ** 0.5) ** 0.5
    q, k = (torch.randn(B, L, H, D, generator=g, device=dev) * sd for _ in range(2))
    v, gr = (torch.randn(B, L, H, D, generator=g, device=dev) for _ in range(2))
    q[..., 0] = 0.0
    k[..., 0] += 100.0 * sd
    m = torch.ones(B, L, device=dev)
    hf = fa._heads_first(q, k, v)
    out, lse = fa._ref_attention_base2(*hf, m[:, None], m[:, None], "max", with_lse=True)
    dl = (out.permute(0, 2, 1, 3) * gr).sum(-1).transpose(1, 2).contiguous()
    inputs["offset"] = {"dq": (lambda a=(q, k, v, gr, lse, dl, m, m): fa._flash_bwd_dq_cuda(*a)),
                        "ref_dq": (fa._ref_flash_bwd_dq(*hf, gr.permute(0, 2, 1, 3), lse, dl, m[:, None]),)}
    fns = ("srhep_flash_fwd", "srhep_packed_fwd", "srhep_flash_bwd_dq", "srhep_flash_bwd_dkv", "srhep_packed_bwd_dq",
           "srhep_packed_bwd_dkv", "srhep_packed_band")
    for name, (p, d) in procs.items():
        line = _build_line(name, p)
        if not line["built"]:
            continue
        lib_path = os.path.join(d, "lib.so")
        _load(lib_path, kernels, fns)
        line["ms"], line["max_rel_err"] = {}, {}
        for key, x in inputs.items():
            for kind in ("fwd", "dq", "dkv"):
                if kind not in x:
                    continue
                line["ms"][f"{kind}_{key}"] = graph_ms(x[kind], 20, chain=8)
                got = x[kind]()
                got = (got[0],) if kind == "fwd" else got if kind == "dkv" else (got,)
                ref = (x["ref_fwd"][0],) if kind == "fwd" else x["ref_" + kind]
                line["max_rel_err"][f"{kind}_{key}"] = max(
                    ((a - b.permute(0, 2, 1, 3)).abs().max() / b.abs().max()).item() for a, b in zip(got, ref))
        if hasattr(kernels._lib, "srhep_read_f32_clocks"):
            buf = (ctypes.c_ulonglong * 16)()
            kernels._lib.srhep_read_f32_clocks(buf)
            for key in ("d16", "d64"):
                inputs[key]["fwd"]()
                torch.cuda.synchronize()
                kernels._lib.srhep_read_f32_clocks(buf)
                live = max(buf[8], 1)
                line[f"clocks_fwd_{key}"] = {
                    "live_blocks": buf[8], "dead_blocks": buf[9], "tiles_per_live_block": buf[7] / live,
                    "cycles_per_live_block": buf[10] / live,
                    **{n: buf[i] / live for i, n in enumerate(("prologue", "loop", "epilogue"))}}
        if hasattr(kernels._lib, "srhep_read_dq_clocks"):
            buf = (ctypes.c_ulonglong * 16)()
            kernels._lib.srhep_read_dq_clocks(buf)
            for key in ("d16", "d64"):
                inputs[key]["dq"]()
                torch.cuda.synchronize()
                kernels._lib.srhep_read_dq_clocks(buf)
                live = max(buf[8], 1)
                line[f"clocks_dq_{key}"] = {
                    "live_blocks": buf[8], "dead_blocks": buf[9], "tiles_per_live_block": buf[7] / live,
                    "cycles_per_live_block": buf[10] / live,
                    **{n: buf[i] / live for i, n in DQ_CLOCK_SLOTS.items()}}
        line["sass_fwd_d16"] = _sass_counts(lib_path, r"flash_fwd_f32_kernelILi16ELb0ELb0E")
        line["sass_dq_d16"] = _sass_counts(lib_path, r"flash_bwd_dq_f32_kernelILi16ELb0E")
        line["sass_dkv_d16"] = _sass_counts(lib_path, r"flash_bwd_dkv_f32_kernelILi16ELb0E")
        print(json.dumps(line), flush=True)


def main():
    sys.path.insert(0, os.getcwd())
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("fwd_variants: no CUDA device")
    if sys.argv[1:2] == ["bwd"]:
        return main_bwd(sys.argv[2:])
    if sys.argv[1:2] == ["f32"]:
        return main_f32(sys.argv[2:])

    import chip_smoke as cs
    from superresolutionhep_tpu_torch.ops import attention_probes as ap
    from superresolutionhep_tpu_torch.ops import flash_attention as fa
    from superresolutionhep_tpu_torch.ops import flash_packed as fp
    from superresolutionhep_tpu_torch.ops import kernels
    from superresolutionhep_tpu_torch.scripts.common import graph_ms

    fwd_sources = ("flash_attention.cu", "attention_probes.cu")
    procs = _build(("flash_fwd.cuh", *fwd_sources), fwd_sources, VARIANTS, sys.argv[1:] or list(VARIANTS), kernels)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    B, H, D, F, L = 10, 4, 64, 256, 2048
    valid, _ = cs.ragged_valid(B, L, dev)
    qkv = torch.randn(B, L, 3 * F, generator=g, device=dev)
    qkv[..., :F] *= 0.5
    qkv = qkv.to(torch.bfloat16)
    q1, k1, v1 = (qkv[..., i * F:(i + 1) * F].view(B, L, H, D) for i in range(3))
    m = valid.float().contiguous()
    _, seg_np, _ = cs.packed_layout()
    seg = torch.from_numpy(seg_np).to(dev)
    qkv7 = torch.randn(seg.shape[0], seg.shape[1], 3, H, D, generator=g, device=dev)
    qkv7[:, :, 0] *= (1.0 / D ** 0.5) * fp.LOG2E * 2.0
    qkv7 = qkv7.to(torch.bfloat16)
    q7, k7, v7 = qkv7[:, :, 0], qkv7[:, :, 1], qkv7[:, :, 2]
    ref7 = fp._ref_packed_fwd(*(t.permute(0, 2, 1, 3) for t in (q7, k7, v7)), seg, "nomax_clip")
    ref7 = ref7.permute(0, 2, 1, 3).float()
    qp = (torch.randn((8, 8, 2048, 64), generator=g, device=dev) * 0.9).to(torch.bfloat16)  # the probes' timed input
    kp = torch.ones((8, 2048), device=dev)
    refs = {"k7_nomax": ref7, "k10": ap._ref_variant(qp, qp, qp, "full").float(),
            "k11": ap._ref_exp_probe(qp, qp, qp, kp, True).float()}
    calls = {
        "k1": lambda: fa._flash_fwd_cuda(q1, k1, v1, m, m, nomax=False, with_lse=True),
        "k2": lambda: fa._flash_fwd_cuda(q1, k1, v1, m, m, nomax=True, with_lse=False),
        "k7": lambda: fp._packed_fwd(q7, k7, v7, seg, nomax=False, with_lse=True),
        "k7_nomax": lambda: fp._packed_fwd(q7, k7, v7, seg, nomax=True, with_lse=False),
        "k10": lambda: ap.attention_variant(qp, qp, qp, "full"),
        "k11": lambda: ap.attention_exp_probe(qp, qp, qp, kp, True),
        "k10_rows64": lambda: ap.attention_variant(qp, qp, qp, "full", block_q=64),
        "k11_rows64": lambda: ap.attention_exp_probe(qp, qp, qp, kp, True, block_q=64),
    }
    for name, (p, d) in procs.items():
        line = _build_line(name, p)
        if not line["built"]:
            continue
        lib = _load(os.path.join(d, "lib.so"), kernels, ("srhep_flash_fwd", "srhep_packed_fwd", "srhep_packed_band",
                                                         "srhep_probe_variant", "srhep_probe_exp_dtype"))
        line["ms"] = {k: graph_ms(fn, 20, chain=8) for k, fn in calls.items()}
        line["max_rel_err"] = {}
        for k, ref in refs.items():
            out = calls[k]()
            out = out[0] if isinstance(out, tuple) else out
            line["max_rel_err"][k] = ((out.float() - ref).abs().max() / ref.abs().max()).item()
        if hasattr(lib, "srhep_read_clocks"):
            buf = (ctypes.c_ulonglong * 16)()
            torch.cuda.synchronize()
            lib.srhep_read_clocks(buf)
            lib.srhep_read_probe_clocks(buf)
            line["cycles_per_tile"] = {}
            for k, fn in calls.items():
                fn()
                torch.cuda.synchronize()
                (lib.srhep_read_probe_clocks if k.startswith(("k10", "k11")) else lib.srhep_read_clocks)(buf)
                tiles = max(buf[7], 1)
                line["cycles_per_tile"][k] = {**{s: buf[i] / tiles for i, s in CLOCK_SLOTS.items()},
                                              "whole_loop": buf[6] / tiles, "tiles": buf[7]}
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
