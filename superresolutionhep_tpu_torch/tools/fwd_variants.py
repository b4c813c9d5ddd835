"""Build variants of the bf16 flash-attention forward (``csrc/flash_attention.cu``
with one construct changed, by string edits in a temporary directory; the
repository is not touched) as libraries of their own, all at once, and time
the forward wrappers with each at ``chip_smoke.py``'s shapes.

    python3 superresolutionhep_tpu_torch/tools/fwd_variants.py [variant ...]

Run from the repository root on a machine with the card and nvcc.  Prints one
JSON line per variant: the ptxas serialisation warnings (C751x) and whether
anything spilled, the device time (ms) of K1/K2 at (10, 2048, 4, 64) with
ragged masks and of K7 robust / no-max at the (8, 5120) packed batch, K7
no-max's error against its plain version, and for ``clocks`` the consumer
warpgroups' cycles per 64-row tile by stage of the loop (from clock64
counters, which themselves slow the kernel by about a third).
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


# the loop stages the clock counters read, by slot of the debug array
CLOCK_SLOTS = {0: "q_wait", 1: "full_wait", 2: "turn_wait", 8: "issue", 3: "s_wait", 4: "softmax", 5: "pv_wait",
               9: "iteration"}

VARIANTS = {
    "base": [],
    "turn_after_softmax": [(
        "        pass_turn();\n        wgmma_wait<1>();\n        fence_operand(s);\n"
        "        tile_softmax<NOMAX>(s, ids + ns * kBK, t, qid0, qid1, m0, m1, l0, l1, al0, al1);\n",
        "        wgmma_wait<1>();\n        fence_operand(s);\n"
        "        tile_softmax<NOMAX>(s, ids + ns * kBK, t, qid0, qid1, m0, m1, l0, l1, al0, al1);\n"
        "        pass_turn();\n")],
    "no_turns": [("constexpr bool kPingPong = NC > 1;", "constexpr bool kPingPong = false;")],
    "stages_3": [("{ return NC == 1 ? 3 : 5; }", "{ return 3; }")],
    "lookahead_1": [("constexpr int kLookahead = 4;", "constexpr int kLookahead = 1;")],
    "clocks": [
        ("namespace srhep {\n\nconstexpr float kClipLo",
         "__device__ unsigned long long srhep_clocks[16];\nnamespace srhep {\n\nconstexpr float kClipLo"),
        ("    mbar_wait(qfull, 0);\n    int stage = 0;",
         "    long long dbg[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};\n    const long long _tb = clock64();\n"
         "    { " + _T0 + " mbar_wait(qfull, 0); " + _tick(0) + " }\n    int stage = 0;"),
        ("        mbar_wait(&full[ns], nph);\n        if (tile[ns] < 0) break;",
         "        { " + _T0 + " mbar_wait(&full[ns], nph); " + _tick(1) + " }\n        if (tile[ns] < 0) break;\n"
         "        dbg[7] += 1;\n        const long long _ti = clock64();"),
        ("        my_turn();\n        wgmma_fence();\n        issue_qk<D>(s, dq);",
         "        { " + _T0 + " my_turn(); " + _tick(2) + " }\n        const long long _tis = clock64();\n"
         "        wgmma_fence();\n        issue_qk<D>(s, dq);"),
        ("        pass_turn();\n        wgmma_wait<1>();\n        fence_operand(s);\n"
         "        tile_softmax<NOMAX>(s, ids + ns * kBK, t, qid0, qid1, m0, m1, l0, l1, al0, al1);\n"
         "        wgmma_wait<0>();",
         "        pass_turn();\n        if (lane == 0 && warp == 0) dbg[8] += clock64() - _tis;\n"
         "        { " + _T0 + " wgmma_wait<1>(); " + _tick(3) + " }\n        fence_operand(s);\n"
         "        { " + _T0 + " tile_softmax<NOMAX>(s, ids + ns * kBK, t, qid0, qid1, m0, m1, l0, l1, al0, al1); "
         + _tick(4) + " }\n        { " + _T0 + " wgmma_wait<0>(); " + _tick(5) + " }"),
        ("        pack_p(s, p);\n        stage = ns;",
         "        pack_p(s, p);\n        if (lane == 0 && warp == 0) dbg[9] += clock64() - _ti;\n        stage = ns;"),
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
    ],
}


def main():
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from superresolutionhep_tpu_torch.ops import flash_attention as fa
    from superresolutionhep_tpu_torch.ops import flash_packed as fp
    from superresolutionhep_tpu_torch.ops import kernels
    from superresolutionhep_tpu_torch.scripts.common import graph_ms

    if not torch.cuda.is_available():
        raise SystemExit("fwd_variants: no CUDA device")
    names = sys.argv[1:] or list(VARIANTS)
    src = (kernels.CSRC / "flash_attention.cu").read_text()
    work = tempfile.mkdtemp(prefix="srhep_fwd_variants_")
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if old not in text:
                raise SystemExit(f"fwd_variants: {name}: the source no longer holds {old[:60]!r}")
            text = text.replace(old, new)
        d = os.path.join(work, name)
        os.makedirs(d)
        with open(os.path.join(d, "flash_attention.cu"), "w") as f:
            f.write(text)
        cmd = ["/usr/local/cuda/bin/nvcc", *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-I", str(kernels.CSRC),
               os.path.join(d, "flash_attention.cu"), "-o", os.path.join(d, "lib.so")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

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
    calls = {
        "k1": lambda: fa._flash_fwd_cuda(q1, k1, v1, m, m, nomax=False, with_lse=True),
        "k2": lambda: fa._flash_fwd_cuda(q1, k1, v1, m, m, nomax=True, with_lse=False),
        "k7": lambda: fp._packed_fwd(q7, k7, v7, seg, nomax=False, with_lse=True),
        "k7_nomax": lambda: fp._packed_fwd(q7, k7, v7, seg, nomax=True, with_lse=False),
    }
    for name, p in procs.items():
        log = p.communicate()[0]
        line = {"variant": name, "built": p.returncode == 0,
                "serialised": sorted(set(re.findall(r"\((C751\d)\)", log))),
                "spills": any(re.search(r"[1-9]\d* bytes spill", x) for x in log.splitlines())}
        if p.returncode:
            print(json.dumps({**line, "log": log[-2000:]}), flush=True)
            continue
        lib = ctypes.CDLL(os.path.join(work, name, "lib.so"))
        for fn in ("srhep_flash_fwd", "srhep_packed_fwd", "srhep_packed_band"):
            getattr(lib, fn).argtypes = kernels._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        kernels._lib = lib
        line["ms"] = {k: graph_ms(fn, 20, chain=8) for k, fn in calls.items()}
        out = calls["k7_nomax"]()[0]
        line["k7_nomax_max_rel_err"] = ((out.float() - ref7).abs().max() / ref7.abs().max()).item()
        if hasattr(lib, "srhep_read_clocks"):
            buf = (ctypes.c_ulonglong * 16)()
            torch.cuda.synchronize()
            lib.srhep_read_clocks(buf)
            line["cycles_per_tile"] = {}
            for k, fn in calls.items():
                fn()
                torch.cuda.synchronize()
                lib.srhep_read_clocks(buf)
                tiles = max(buf[7], 1)
                line["cycles_per_tile"][k] = {**{s: buf[i] / tiles for i, s in CLOCK_SLOTS.items()},
                                              "whole_loop": buf[6] / tiles, "tiles": buf[7]}
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
