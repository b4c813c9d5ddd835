"""Kernel experiments on the card: the tensor cores' reach on the shapes
attention uses, and what each part of the attention forward costs.

    python -m superresolutionhep_tpu_torch.scripts.kernel_experiments [--device cuda]

Counterpart of the JAX package's ``scripts/kernel_experiments.py``.  Prints
one JSON line per measurement, each with the card's name and power limit:
  * ``probe`` lines: plain ``torch.matmul`` of two 4096^2 bf16 matrices, the
    D=64 contraction (8*8*2048, 64) x (64, 2048), and the dense attention
    (two einsums and a softmax) at (B, L, H, D) = (8, 2048, 8, 64): the
    yardsticks (``tfs`` in TFLOP/s);
  * ``variant`` lines: the attention-probe kernel (ops/attention_probes.py,
    K10) in its four modes at (8, 8, 2048, 64) on the default tile (the
    shipped forward's: 192 query rows x 64 keys at that shape), then
    ``full`` at the other tile shapes of ``TILES``.
Times are CUDA-event times over a CUDA graph of chained launches.  A
configuration that cannot launch prints ``skipped`` with the launcher's
error and the sweep goes on; it never turns into a plain-version result.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..ops.attention_probes import MODES, TILES, attention_variant
from ..ops.flash_attention import fwd_tile_rows, sm_count
from .common import card, graph_ms, require_cuda


def emit(obj, smi):
    print(json.dumps(dict(obj, card=smi)), flush=True)


def mm_peak(dev, smi, reps=20):
    M = 4096
    a = torch.ones((M, M), dtype=torch.bfloat16, device=dev)
    ms = graph_ms(lambda: torch.matmul(a, a), reps)
    emit({"probe": "tc_4096_matmul", "ms": round(ms, 4), "tfs": round(2 * M**3 / ms / 1e9, 1)}, smi)
    # D=64 contraction, the q k^T shape
    L = 2048
    b = torch.ones((8 * 8 * L, 64), dtype=torch.bfloat16, device=dev)
    c = torch.ones((64, L), dtype=torch.bfloat16, device=dev)
    ms = graph_ms(lambda: torch.matmul(b, c), reps)
    emit({"probe": "tc_d64_contraction", "ms": round(ms, 4), "tfs": round(2 * b.shape[0] * L * 64 / ms / 1e9, 1)},
         smi)
    # dense attention at the bench shape (scores materialised), for comparison
    B, Lq, H, D = 8, 2048, 8, 64
    q = torch.ones((B, H, Lq, D), dtype=torch.bfloat16, device=dev)

    def attn():  # bf16 products with fp32 accumulation, softmax in fp32
        s = torch.matmul(q, q.transpose(-1, -2)).float()
        p = torch.softmax(s, dim=-1).to(torch.bfloat16)
        return torch.matmul(p, q)

    ms = graph_ms(attn, max(3, reps // 4), chain=2)
    emit({"probe": "dense_attn_8_2048", "ms": round(ms, 3), "tfs": round(4 * B * H * Lq * Lq * D / ms / 1e9, 1)}, smi)


def run_variant(mode, dev, smi, B=8, L=2048, H=8, D=64, BQ=None, BK=64, reps=20, seed=0):
    BQ = BQ or fwd_tile_rows(B, H, L, sm_count(dev))
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, H, L, D), generator=g, device=dev).to(torch.bfloat16)
    ms = graph_ms(lambda: attention_variant(q, q, q, mode, block_q=BQ, block_k=BK), reps)
    flops = 4 * B * H * L * L * D
    emit({"variant": mode, "shape": [B, L, H, D], "blocks": [BQ, BK], "ms": round(ms, 4),
          "tfs": round(flops / ms / 1e9, 1)}, smi)


def _safe(smi, fn, *a, **k):
    try:
        fn(*a, **k)
    except (RuntimeError, ValueError) as e:  # a configuration that cannot launch: report it, keep sweeping
        emit({"skipped": fn.__name__, "kwargs": {kk: vv for kk, vv in k.items() if kk in ("BQ", "BK")},
              "error": str(e)[:200]}, smi)


def sweep(device="cuda", reps=20):
    dev = require_cuda(device)
    smi = card()
    _safe(smi, mm_peak, dev, smi, reps=reps)
    for mode in MODES:
        _safe(smi, run_variant, mode, dev, smi, reps=reps)
    default = (fwd_tile_rows(8, 8, 2048, sm_count(dev)), 64)
    for bq, bk in TILES:
        if (bq, bk) != default:
            _safe(smi, run_variant, "full", dev, smi, BQ=bq, BK=bk, reps=reps)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sweep(args.device)


if __name__ == "__main__":
    main()
