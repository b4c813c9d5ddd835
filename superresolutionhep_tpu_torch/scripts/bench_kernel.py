"""Attention kernel microbenchmark: the forward (K1) and the train step's
forward plus backward (K1 with LSE, K5, K6) through the autograd Function.

Counterpart of the JAX package's ``scripts/bench_kernel.py``, with its four
cases (one of them 60% valid: padding that block skipping should track), its
flop arithmetic (on the valid region; the backward as the forward recomputed
twice plus five gradient products, 14 B H Lv^2 D, plus the forward) and its
fields, in bf16 or with ``--fp32``.  Each time is the device time of one call
in a CUDA graph (``common.graph_ms``) on the pre-folded entry
(``masked_flash_attention_T``, q scaled by a device constant made once; the
public entry's host-built scale constant cannot be captured); the backward is
``torch.autograd.grad`` of sum(o^2) captured with it.  Beside each TF/s,
``*_bound_ms``: the card's least time for the same work
(``common.fwd_bounds`` / ``fp32_attention_bounds``: the flops the kernels
need, each input read once and each output written once, one exp2 per live
pair — two for forward plus backward).  One forward and one forward plus
backward run first under ``checked()`` (``chip_smoke.py`` passes its launch
checker).

    python -m superresolutionhep_tpu_torch.scripts.bench_kernel [--fp32] [--reps 20] [--device cuda]

Prints the card's name and power limit, then one JSON line per case.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os

import numpy as np
import torch

from ..ops.flash_attention import LOG2E, masked_flash_attention_T
from .common import RUNS_DIR, attention_bounds, chained_ms, device_line, measure_device, sync, write_json

# (B, L, H, D, valid_fraction)
CASES = [
    (8, 2048, 8, 64, 1.0),
    (4, 3584, 8, 64, 1.0),
    (4, 3584, 8, 64, 0.6),  # bucketed padding: block skip should track this
    (16, 1024, 8, 64, 1.0),
]
TINY = {"cases": [(2, 256, 2, 64, 1.0), (2, 256, 2, 64, 0.6)]}  # --device cpu


def flops(B, H, D, n_valid):
    """The JAX script's useful flops on the valid region: forward, and
    forward plus backward (the backward reruns the forward)."""
    fwd = 4 * B * H * n_valid * n_valid * D
    return fwd, 14 * B * H * n_valid * n_valid * D + fwd


def bench(dev, dtype=torch.bfloat16, reps=20, cases=CASES, checked=contextlib.nullcontext):
    results = []
    for B, L, H, D, frac in cases:
        rng = np.random.default_rng(0)
        q, k, v = (torch.from_numpy(rng.normal(size=(B, L, H, D)).astype(np.float32)).to(dev, dtype)
                   for _ in range(3))
        n_valid = int(L * frac)
        valid = (torch.arange(L, device=dev)[None, :] < n_valid).expand(B, L).float().contiguous()
        c = torch.tensor(LOG2E / np.sqrt(D), dtype=dtype, device=dev)
        kT, vT = k.permute(0, 2, 3, 1), v.permute(0, 2, 3, 1)

        def fwd():
            return masked_flash_attention_T((q * c).permute(0, 2, 3, 1), kT, vT, valid, valid)

        qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q, k, v))

        def fwd_bwd():
            o = masked_flash_attention_T((qg * c).permute(0, 2, 3, 1), kg.permute(0, 2, 3, 1),
                                         vg.permute(0, 2, 3, 1), valid, valid)
            return torch.autograd.grad((o.float() ** 2).sum(), (qg, kg, vg))

        with checked():
            with torch.no_grad():
                o = fwd()
            g = fwd_bwd()
        sync(dev)
        finite = bool(torch.isfinite(o).all()) and all(bool(torch.isfinite(t).all()) for t in g)
        with torch.no_grad():
            dt_f = chained_ms(fwd, dev, reps) / 1e3
        dt_b = chained_ms(fwd_bwd, dev, reps) / 1e3

        fwd_flops, bwd_flops = flops(B, H, D, n_valid)
        isz = torch.finfo(dtype).bits // 8
        pairs = B * H * n_valid * n_valid
        io = B * L * H * D * isz
        res = {
            "shape": [B, L, H, D],
            "valid_frac": frac,
            "dtype": "float32" if dtype == torch.float32 else "bfloat16",
            "fwd_ms": round(dt_f * 1e3, 2),
            "fwd_tfs": round(fwd_flops / dt_f / 1e12, 1),
            "fwd_bwd_ms": round(dt_b * 1e3, 2),
            "fwd_bwd_tfs": round(bwd_flops / dt_b / 1e12, 1),
            "finite": finite,
        }
        if dev.type == "cuda":
            # q, k, v and the masks read, o (and dq, dk, dv) written; the
            # kernels' flops: forward 4, dq 6, dk/dv 8 products of H D a pair
            fb = attention_bounds(dtype, 4.0 * pairs * D, 4 * io + 2 * B * L * 4, pairs)
            bb = attention_bounds(dtype, 18.0 * pairs * D, 6 * io + 2 * B * L * 4, 2 * pairs)
            res.update({"fwd_bound_ms": fb["bound_ms"], "fwd_bound_by": fb["bound_by"],
                        "fwd_bwd_bound_ms": bb["bound_ms"], "fwd_bwd_bound_by": bb["bound_by"]})
        print(json.dumps(res), flush=True)
        results.append(res)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="default: runs/measure/bench_kernel_{bf16,fp32}.json")
    args = ap.parse_args(argv)
    dev = measure_device(args.device)
    print(device_line(dev), flush=True)
    dtype = torch.float32 if args.fp32 else torch.bfloat16
    results = bench(dev, dtype, args.reps, **({} if dev.type == "cuda" else TINY))
    out = args.out or os.path.join(RUNS_DIR, f"bench_kernel_{'fp32' if args.fp32 else 'bf16'}.json")
    print("wrote", write_json(out, {"card": device_line(dev), "results": results}), flush=True)
    return results


if __name__ == "__main__":
    main()
