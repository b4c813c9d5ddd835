"""Per-call dispatch overhead against the device time of the production
attention forward (K1, bf16, every key valid).

Counterpart of the JAX package's ``scripts/probe_dispatch.py``, with its
shapes and fields.  At each shape:

  (a) ``per_dispatch_ms``: one call of the public entry
      ``masked_flash_attention`` at a time, synchronised after every call
      (``reps`` = 20 after one warm-up call);
  (b) ``chained_ms``: ``REPS`` = 50 calls chained, each output the next
      call's q, captured in one CUDA graph (``common.graph_ms``) on the
      pre-folded entry (q scaled by a device constant made once, fp32 masks
      made once: the public entry's host-built scale constant cannot be
      captured); per call.

``dispatch_overhead_ms`` is (a) - (b).  The synchronised calls of (a) run
under ``torch.profiler`` as well (``tools/trace_summary.py``): their device
time per call is printed beside them as ``per_dispatch_device_ms``.  One call
runs first under ``checked()`` (``chip_smoke.py`` passes its launch checker).

    python -m superresolutionhep_tpu_torch.scripts.probe_dispatch [--device cuda] [--out PATH]

Prints the card's name and power limit, then one JSON line per shape.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import numpy as np
import torch

from ..ops.flash_attention import LOG2E, masked_flash_attention, masked_flash_attention_T
from ..tools.trace_summary import ProfiledWindow
from .common import RUNS_DIR, chained_ms, device_line, measure_device, sync, write_json

SHAPES = [(8, 2048, 8, 64), (4, 3584, 8, 64)]
REPS = 50  # calls chained in one captured graph, as the JAX script's lax.scan
TINY = {"shapes": [(2, 256, 2, 64)], "chain": 4}  # --device cpu


def probe(dev, shapes=SHAPES, chain=REPS, reps=20, checked=contextlib.nullcontext, windows=None, trace=None):
    """Both measures at each shape; ``windows`` (a list) collects the profiled
    windows, ``trace`` a directory for their Chrome traces."""
    results = []
    for B, L, H, D in shapes:
        rng = np.random.default_rng(0)
        q = torch.from_numpy(rng.normal(size=(B, L, H, D)).astype(np.float32)).to(dev, torch.bfloat16)
        valid = torch.ones((B, L), dtype=torch.bool, device=dev)
        scale = 1.0 / np.sqrt(D)

        def one():
            return masked_flash_attention(q, q, q, valid, valid, scale)

        with checked():
            one()
        one()
        sync(dev)
        trace_path = os.path.join(trace, f"probe_dispatch_{B}x{L}.json") if trace else None
        with ProfiledWindow(dev, f"probe_dispatch {B}x{L} per dispatch", trace_path) as w:
            t0 = time.time()
            for _ in range(reps):
                o = one()
                sync(dev)
            dt1 = (time.time() - t0) / reps
        if windows is not None:
            windows.append(w)

        mask = valid.float()
        c = torch.tensor(scale * LOG2E, dtype=torch.bfloat16, device=dev)
        kT = q.permute(0, 2, 3, 1)

        def chained():
            x = q
            for _ in range(chain):
                x = masked_flash_attention_T((x * c).permute(0, 2, 3, 1), kT, kT, mask, mask).permute(0, 3, 1, 2)
            return x

        dtn = chained_ms(chained, dev, reps=5) / 1e3 / chain
        flops = 4 * B * H * L * L * D
        res = {
            "shape": [B, L, H, D],
            "per_dispatch_ms": round(dt1 * 1e3, 3),
            "per_dispatch_tfs": round(flops / dt1 / 1e12, 1),
            "chained_ms": round(dtn * 1e3, 3),
            "chained_tfs": round(flops / dtn / 1e12, 1),
            "dispatch_overhead_ms": round((dt1 - dtn) * 1e3, 3),
            "per_dispatch_device_ms": w.summary["kernel_us"] / 1e3 / reps if dev.type == "cuda" else None,
            "chain": chain,
            "finite": bool(torch.isfinite(o).all()),
        }
        print(json.dumps(res), flush=True)
        results.append(res)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(RUNS_DIR, "probe_dispatch.json"))
    args = ap.parse_args(argv)
    dev = measure_device(args.device)
    print(device_line(dev), flush=True)
    results = probe(dev, **({} if dev.type == "cuda" else TINY))
    print("wrote", write_json(args.out, {"card": device_line(dev), "results": results}), flush=True)
    return results


if __name__ == "__main__":
    main()
