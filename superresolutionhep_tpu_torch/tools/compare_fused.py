"""Time one checkout's bf16 fused kernels K3 (LN + modulate + QKV) and K4
(the MLP half-layer) on the card at the shapes of the multipart model: the
serve shape (10, 2048) with per-batch rows, and the packed batch of the
ensemble sampler, (80, 5120), with per-cell rows and, where the checkout's
wrappers take ``segment_ids``, per-segment rows.  ``compare_fused.sh`` runs
it for two checkouts in the order old, new, new, old.

    python3 superresolutionhep_tpu_torch/tools/compare_fused.py <checkout> <label>

The checkout is imported (its ``chip_smoke.py`` and package) and builds its
kernels into ``<checkout>/build``.  Prints one JSON line per case (median of
CUDA-graph replays of the wrapper, ms), tagged with the label.
"""

from __future__ import annotations

import inspect
import json
import os
import sys


def main():
    root, label = os.path.abspath(sys.argv[1]), sys.argv[2]
    sys.path.insert(0, root)
    os.environ["SRHEP_TORCH_BUILD_DIR"] = os.path.join(root, "build")
    import numpy as np
    import torch

    import chip_smoke as cs
    from superresolutionhep_tpu_torch.ops import fused_mlp as fm
    from superresolutionhep_tpu_torch.ops import fused_qkv as fq
    from superresolutionhep_tpu_torch.ops import kernels
    from superresolutionhep_tpu_torch.scripts.common import graph_ms

    if not torch.cuda.is_available():
        raise SystemExit("compare_fused: no CUDA device")
    kernels.library()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    takes_segments = "segment_ids" in inspect.signature(fq.fused_ln_mod_proj).parameters
    F = Fh = 256
    _, seg_np, _ = cs.packed_layout()
    for rows, B, L in (("batch", 10, 2048), ("cell", 80, 5120), ("segment", 80, 5120)):
        if rows == "segment" and not takes_segments:
            continue
        seg = torch.from_numpy(np.tile(seg_np, (B // seg_np.shape[0], 1))).to(dev) if rows == "segment" else None
        shape = {"batch": (B, F), "cell": (B, L, F), "segment": (B, L // 128 + 1, F)}[rows]
        kw = {"segment_ids": seg} if seg is not None else {}
        x = randn(B, L, F, dtype=torch.bfloat16)
        w, bias = randn(3 * F, F, scale=0.03, dtype=torch.bfloat16).t(), randn(3 * F, scale=0.1)
        ea, eb = 1.0 + randn(*shape, scale=0.1), randn(*shape, scale=0.1)
        ms = graph_ms(lambda: fq.fused_ln_mod_proj(x, ea, eb, w, bias, **kw), 20, chain=4)
        print(json.dumps({"label": label, "kernel": "fused_qkv", "rows": rows, "B": B, "L": L, "ms": ms}), flush=True)
        att = randn(B, L, F, scale=0.5, dtype=torch.bfloat16)
        ga, gm = randn(*shape, scale=0.5), randn(*shape, scale=0.5)
        w0, w1 = randn(Fh, F, scale=0.06, dtype=torch.bfloat16).t(), randn(F, Fh, scale=0.06, dtype=torch.bfloat16).t()
        b0, b1 = randn(Fh, scale=0.1), randn(F, scale=0.1)
        args = (x, att, ga, ea, eb, gm, w0, b0, w1, b1)
        ms = graph_ms(lambda: fm.fused_dit_mlp(*args, **kw), 20, chain=4)
        print(json.dumps({"label": label, "kernel": "fused_mlp", "rows": rows, "B": B, "L": L, "ms": ms}), flush=True)
        del x, att, ea, eb, ga, gm, args
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
