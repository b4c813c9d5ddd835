"""Build variants of the bf16 fused kernels K3/K4 (``csrc/fused_qkv.cu`` and
``csrc/fused_mlp.cu`` with string edits and extra nvcc flags, in a temporary
directory; the repository is not touched) as libraries of their own, all at
once, and time the two wrappers with each at ``chip_smoke.py``'s shapes:
(10, 2048) with per-batch rows and the (80, 5120) packed batch of the
ensemble sampler with per-segment rows.

    python3 superresolutionhep_tpu_torch/tools/fused_variants.py [variant ...]

Run from the repository root on a machine with the card and nvcc.  Prints the
card's name and power limit, then one JSON line per variant: the ptxas
serialisation warnings (C751x) and whether anything spilled, the device time
(ms, median of CUDA-graph replays) and the largest error against the plain
version of each case, and for ``clocks`` (built with -DSRHEP_FUSED_CLOCKS) the
consumer warpgroups' cycles per 64-row warpgroup tile by stage, from clock64
counters (which themselves slow the kernels).
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

QKV_SLOTS = {1: "prologue", 2: "slab_waits", 3: "products", 4: "epilogue", 5: "whole_tile"}
MLP_SLOTS = {1: "prologue", 2: "slab_waits", 3: "products_1", 4: "z_to_bf16", 5: "products_2", 6: "epilogue",
             7: "whole_tile"}

# K4: the modulation rows of a prologue step read before its first reductions
MOD_EARLY = [
    ("fused_mlp.cu", """      float v[R][kMaxChunks][4];
      unsigned prow[R];""", """      float v[R][kMaxChunks][4];
      float4 ea4[R][NCH], eb4[R][NCH];
      unsigned prow[R];"""),
    ("fused_mlp.cu", """          const float4 g4 = *reinterpret_cast<const float4*>(ga + prow[j] + f);""",
     """          const float4 g4 = *reinterpret_cast<const float4*>(ga + prow[j] + f);
          ea4[j][i] = *reinterpret_cast<const float4*>(ea + prow[j] + f);
          eb4[j][i] = *reinterpret_cast<const float4*>(eb + prow[j] + f);"""),
    ("fused_mlp.cu", """          const float4 a4 = *reinterpret_cast<const float4*>(ea + prow[j] + f);
          const float4 b4 = *reinterpret_cast<const float4*>(eb + prow[j] + f);""",
     """          const float4 a4 = ea4[j][i], b4 = eb4[j][i];"""),
]

# name -> (string edits of (file, old, new), each at its first place in the
# file, extra nvcc flags)
VARIANTS = {
    "base": ([], []),
    "clocks": ([], ["-DSRHEP_FUSED_CLOCKS"]),
    "qkv_ln_rows_2": ([("fused_qkv.cu", "kQkvLnRows = 4;", "kQkvLnRows = 2;")], []),
    "mlp_ln_rows_2": ([("fused_mlp.cu", "kMlpLnRows = 4;", "kMlpLnRows = 2;")], []),
    "mlp_ln_rows_8": ([("fused_mlp.cu", "kMlpLnRows = 4;", "kMlpLnRows = 8;")], []),
    "mlp_mod_early": (MOD_EARLY, []),
    "mlp_mod_early_rows_8": (MOD_EARLY + [("fused_mlp.cu", "kMlpLnRows = 4;", "kMlpLnRows = 8;")], []),
}


def ptxas_rows(log):
    """(kernel, registers, spill stores, spill loads) of each bf16 fused kernel in a -Xptxas -v log."""
    rows, name, spill = [], None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*(fused_(?:qkv|mlp)_wgmma_kernel\S*)'", line)
        if m:
            name = m.group(1)
        sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if sp:
            spill = (int(sp.group(1)), int(sp.group(2)))
        reg = re.search(r"Used (\d+) registers", line)
        if reg and name:
            rows.append([name[:40], int(reg.group(1)), *spill])
            name = None
    return rows


def main():
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch

    import chip_smoke as cs
    from superresolutionhep_tpu_torch.ops import fused_mlp as fm
    from superresolutionhep_tpu_torch.ops import fused_qkv as fq
    from superresolutionhep_tpu_torch.ops import kernels
    from superresolutionhep_tpu_torch.scripts.common import card, graph_ms

    if not torch.cuda.is_available():
        raise SystemExit("fused_variants: no CUDA device")
    print(card(), flush=True)
    names = sys.argv[1:] or list(VARIANTS)
    work = tempfile.mkdtemp(prefix="srhep_fused_variants_")
    procs = {}
    for name in names:
        edits, flags = VARIANTS[name]
        d = os.path.join(work, name)
        shutil.copytree(kernels.CSRC, d)
        for fname, old, new in edits:
            path = os.path.join(d, fname)
            text = open(path).read()
            if old not in text:
                raise SystemExit(f"fused_variants: {name}: {fname} no longer holds {old[:60]!r}")
            open(path, "w").write(text.replace(old, new, 1))  # the first place: the bf16 body
        cmd = ["/usr/local/cuda/bin/nvcc", *kernels.NVCC_FLAGS, *flags, "-Xptxas", "-v", "-shared", "-I", d,
               os.path.join(d, "fused_qkv.cu"), os.path.join(d, "fused_mlp.cu"), "-o", os.path.join(d, "lib.so")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    F = Fh = 256
    _, seg_np, _ = cs.packed_layout()
    calls, refs = {}, {}
    for label, B, L, seg in (("batch_10x2048", 10, 2048, None),
                             ("segment_80x5120", 10 * cs.PACKED_ROWS, cs.PACKED_S,
                              torch.from_numpy(np.tile(seg_np, (10, 1))).to(dev))):
        shape = (B, F) if seg is None else (B, L // 128 + 1, F)
        x = randn(B, L, F, dtype=torch.bfloat16)
        w, bias = randn(3 * F, F, scale=0.03, dtype=torch.bfloat16).t(), randn(3 * F, scale=0.1)
        ea, eb, ga, gm = 1.0 + randn(*shape, scale=0.1), randn(*shape, scale=0.1), randn(*shape, scale=0.5), \
            randn(*shape, scale=0.5)
        att = randn(B, L, F, scale=0.5, dtype=torch.bfloat16)
        w0, w1 = randn(Fh, F, scale=0.06, dtype=torch.bfloat16).t(), randn(F, Fh, scale=0.06, dtype=torch.bfloat16).t()
        b0, b1 = randn(Fh, scale=0.1), randn(F, scale=0.1)
        margs = (x, att, ga, ea, eb, gm, w0, b0, w1, b1)
        calls[f"k3_{label}"] = (lambda x=x, ea=ea, eb=eb, w=w, bias=bias, seg=seg:
                                fq.fused_ln_mod_proj(x, ea, eb, w, bias, segment_ids=seg))
        calls[f"k4_{label}"] = lambda margs=margs, seg=seg: fm.fused_dit_mlp(*margs, segment_ids=seg)
        refs[f"k3_{label}"] = fq._ref_ln_mod_proj_rows(x, ea, eb, w, bias, seg).float()
        refs[f"k4_{label}"] = fm._ref_dit_mlp_rows(*margs, seg).float()

    for name, p in procs.items():
        log = p.communicate()[0]
        line = {"variant": name, "built": p.returncode == 0,
                "serialised": sorted(set(re.findall(r"\((C751\d)\)", log))),
                "spills": any(re.search(r"[1-9]\d* bytes spill", x) for x in log.splitlines()),
                "wgmma_kernels": ptxas_rows(log)}
        if p.returncode:
            print(json.dumps({**line, "log": log[-2000:]}), flush=True)
            continue
        lib = ctypes.CDLL(os.path.join(work, name, "lib.so"))
        for fn in ("srhep_fused_qkv", "srhep_fused_mlp"):
            getattr(lib, fn).argtypes = kernels._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        kernels._lib = lib
        line["max_abs_err"] = {k: (fn().float() - refs[k]).abs().max().item() for k, fn in calls.items()}
        line["ms"] = {k: graph_ms(fn, 20, chain=4) for k, fn in calls.items()}
        if hasattr(lib, "srhep_read_qkv_clocks"):
            line["cycles_per_tile"] = {}
            buf = (ctypes.c_ulonglong * 8)()
            for k, fn in calls.items():
                reader, slots = ((lib.srhep_read_qkv_clocks, QKV_SLOTS) if k.startswith("k3")
                                 else (lib.srhep_read_mlp_clocks, MLP_SLOTS))
                torch.cuda.synchronize()
                reader(buf)
                fn()
                torch.cuda.synchronize()
                reader(buf)
                tiles = max(buf[0], 1)
                line["cycles_per_tile"][k] = {**{s: buf[i] / tiles for i, s in slots.items()}, "tiles": buf[0]}
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
