"""Chained (dispatch-free) A/B of forward-kernel variants on the card: the
exponential in bf16 or in fp32, and the tile shape, at the two production
bucket lengths.

    python -m superresolutionhep_tpu_torch.scripts.probe_exp_dtype [--device cuda]

Counterpart of the JAX package's ``scripts/probe_exp_dtype.py``.  The kernel
is the masked running-max attention forward (ops/attention_probes.py, K11)
with an all-ones key mask, as the JAX script passes.  Each configuration
chains ``REPS`` = 50 launches, each output the next launch's q, inside one
CUDA graph, and prints one JSON line (``shape``, ``blocks``, ``exp_bf16``,
``ms`` per launch, ``tfs``) with the card's name and power limit.  A
configuration that cannot launch prints its ``error`` and the sweep goes on.
"""

from __future__ import annotations

import argparse
import json

import torch

from ..ops.attention_probes import TILES, attention_exp_probe
from .common import card, graph_ms, require_cuda

REPS = 50  # launches chained in one captured graph, as the JAX script's lax.scan


def bench(B, L, H, D, BQ, BK, exp_bf16, dev, smi, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, H, L, D), generator=g, device=dev).to(torch.bfloat16)
    km = torch.ones((B, L), dtype=torch.float32, device=dev)

    def chained():
        c = q
        for _ in range(REPS):
            c = attention_exp_probe(c, q, q, km, exp_bf16, block_q=BQ, block_k=BK)
        return c

    try:
        ms = graph_ms(chained, reps=5, chain=1) / REPS
    except (RuntimeError, ValueError) as e:  # cannot launch: report it, keep sweeping
        print(json.dumps({"blocks": [BQ, BK], "exp_bf16": exp_bf16, "error": str(e)[:200], "card": smi}), flush=True)
        return
    flops = 4 * B * H * L * L * D
    print(json.dumps({"shape": [B, L, H, D], "blocks": [BQ, BK], "exp_bf16": exp_bf16, "ms": round(ms, 4),
                      "tfs": round(flops / ms / 1e9, 1), "card": smi}), flush=True)


def sweep(device="cuda"):
    """Both exp dtypes at (8, 2048) and fp32 exp at the 3584 bucket, each on
    every tile of ``TILES`` (the default, the shipped forward's, is 192 x 64
    at both shapes): 9 configurations."""
    dev = require_cuda(device)
    smi = card()
    for exp_bf16 in (True, False):
        for bq, bk in TILES:
            bench(8, 2048, 8, 64, bq, bk, exp_bf16, dev, smi)
    # the 3584 bucket (a multiple of 128 but not of 256 or 512, nor of 192)
    for bq, bk in TILES:
        bench(4, 3584, 8, 64, bq, bk, False, dev, smi)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sweep(args.device)


if __name__ == "__main__":
    main()
