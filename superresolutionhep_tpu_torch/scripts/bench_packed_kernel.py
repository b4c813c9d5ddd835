"""Segment-packed attention (K7) against the bucketed kernel (K1/K2) on the
same event set, over the query tiles K7 is built for.

Counterpart of the JAX package's ``scripts/bench_packed_kernel.py``, with its
event set (256 sizes of 1200-4800 cells from seed 42, the bench's multipart
distribution), its packing (``data/packing.py::pack_events``, rows of 5120,
12 a batch), its fields and its two rates:
  * ``tfs_true``: TF/s on the mask-true attention flops, 4 H D sum n_i^2;
  * ``tfs_exec``: TF/s on the flops the kernel walks: the band of key tiles
    of each query tile (packed), or the padded bucket (bucketed; an upper
    bound, block skipping trims the tails);
and ``band_overhead`` / ``pad_overhead``, executed over true pairs, less 1.

The packed legs, robust and no-max: the public entry ``packed_flash_attention``
(the kernel picks its tile, ``fwd_tile_rows``), then each tile of
``K7_TILES`` forced (``_packed_fwd_cuda(block_q=...)`` on q scaled once).  The
JAX script's square blocks 512/256/128 are printed as not applicable: the
Hopper kernel takes query tiles of 64 or 192 rows over 64-key tiles and is
never replaced by its plain version here.  The bucketed leg: 512-cell quantum,
batches of at most 64 rows and 64 * 1536 cells, tails padded with dead rows,
through ``masked_flash_attention``.  Times: the JAX script's loop (every batch
dispatched, one synchronisation a pass), ``reps`` passes after a warm-up.
One pass of the default packed leg also runs under ``torch.profiler``
(``tools/trace_summary.py``); one call of each path runs first under
``checked()`` (``chip_smoke.py`` passes its launch checker).

    python -m superresolutionhep_tpu_torch.scripts.bench_packed_kernel [--reps 10] [--rows 12] [--S 5120] [--seed 42]

Prints the card's name and power limit, then one JSON line per configuration.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import numpy as np
import torch

from ..data.packing import pack_events
from ..ops.flash_attention import FWD_BLOCK_K, LOG2E, masked_flash_attention
from ..ops.flash_packed import PAD_SEG, _packed_fwd_cuda, _ref_packed_band, packed_flash_attention
from ..tools.trace_summary import ProfiledWindow
from .common import RUNS_DIR, device_line, measure_device, sync, write_json

H, D = 8, 64
JAX_BLOCKS = (512, 256, 128)  # the TPU kernel's square blocks
K7_TILES = ((192, FWD_BLOCK_K), (64, FWD_BLOCK_K))  # the bf16 K7 build's (query rows, keys) per tile
QUANTUM, MAX_ROWS, ROW_CELLS = 512, 64, 64 * 1536  # the bucketed baseline's batching
TINY = {"n_events": 8, "lo": 100, "hi": 500, "S": 1024, "rows": 2}  # --device cpu


def event_counts(seed=42, n_events=256, lo=1200, hi=4800):
    """The JAX script's event sizes: ``n_events`` draws in [lo, hi]."""
    return np.random.default_rng(seed).integers(lo, hi + 1, n_events)


def segment_ids(layouts, S):
    """(rows, S) int32 segment ids of each packed batch, ``PAD_SEG`` on padding."""
    out = []
    for lay in layouts:
        seg = np.full((len(lay.rows), S), PAD_SEG, np.int32)
        for bi, row in enumerate(lay.rows):
            for si, (_, off, n) in enumerate(sorted(row, key=lambda t: t[1])):
                seg[bi, off: off + n] = si
        out.append(seg)
    return out


def band_exec_pairs(seg, block_q, block_k):
    """(query, key) pairs the band of (block_q x block_k) tiles covers: each
    query tile's key tiles times the tile's rows (a ragged last tile counts
    its own rows) times ``block_k``."""
    S = seg.shape[1]
    band = _ref_packed_band(torch.from_numpy(seg), block_q, block_k).numpy()
    rows = np.minimum(block_q, S - block_q * np.arange(band.shape[1], dtype=np.int64))
    return float((band[..., 1].astype(np.float64) * rows[None, :]).sum() * block_k)


def buckets(counts, quantum=QUANTUM):
    """The bucketed baseline's batches: (L, event indices) with every event
    padded to the quantum, at most ``MAX_ROWS`` rows and ``ROW_CELLS`` cells."""
    pad = (-(-counts // quantum) * quantum).astype(int)
    out = []
    for L in sorted(set(pad)):
        idxs = np.nonzero(pad == L)[0]
        bs = max(1, min(MAX_ROWS, ROW_CELLS // L))
        out += [(int(L), bs, idxs[s: s + bs]) for s in range(0, len(idxs), bs)]
    return out


def accounting(counts, S=5120, rows=12, tiles=K7_TILES + tuple((b, b) for b in JAX_BLOCKS)):
    """The pair counts behind the rates: mask-true pairs, the band's executed
    pairs per tile of ``tiles`` (where the row length allows it), and the
    padded buckets' pairs."""
    segs = segment_ids(pack_events(counts, S=S, rows_per_batch=rows), S)
    c = counts.astype(np.float64)
    return {"true_pairs": float((c ** 2).sum()),
            "band_exec_pairs": {t: sum(band_exec_pairs(s, *t) for s in segs) for t in tiles if S % t[1] == 0},
            "bucket_exec_pairs": float(sum(len(ix) * L * L for L, _, ix in buckets(counts)))}


def _time_passes(run, datas, reps, dev):
    """The JAX script's timing: one call on the first batch, a warm pass, then
    ``reps`` passes, each dispatching every batch and synchronising once."""
    run(*datas[0])
    for d in datas:
        run(*d)
    sync(dev)
    t0 = time.time()
    for _ in range(reps):
        for d in datas:
            out = run(*d)
        sync(dev)
    return (time.time() - t0) / reps, out


def bench(dev, reps=10, rows=12, S=5120, seed=42, n_events=256, lo=1200, hi=4800,
          checked=contextlib.nullcontext, windows=None, trace=None):
    """The sweep; ``windows`` (a list) collects the profiled windows,
    ``trace`` a directory for their Chrome traces."""
    counts = event_counts(seed, n_events, lo, hi)
    acc = accounting(counts, S, rows, K7_TILES if dev.type == "cuda" else ())
    true_flops = 4.0 * H * D * acc["true_pairs"]
    gen = torch.Generator(device=dev).manual_seed(seed)
    scale = 1.0 / np.sqrt(D)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=torch.float32).to(torch.bfloat16)

    results = []
    layouts = pack_events(counts, S=S, rows_per_batch=rows)
    pdatas = [(randn(len(s), S, H, D), randn(len(s), S, H, D), randn(len(s), S, H, D),
               torch.from_numpy(s).to(dev)) for s in segment_ids(layouts, S)]
    bdatas = []
    for L, bs, chunk in buckets(counts):
        cnt = np.zeros(bs, np.int64)
        cnt[: len(chunk)] = counts[chunk]
        valid = torch.from_numpy(np.arange(L)[None, :] < cnt[:, None]).to(dev)
        bdatas.append((randn(bs, L, H, D), randn(bs, L, H, D), randn(bs, L, H, D), valid))
    with checked():
        for softmax in ("max", "nomax_clip"):
            packed_flash_attention(*pdatas[0], scale=scale, softmax=softmax)
            masked_flash_attention(*bdatas[0][:3], bdatas[0][3], bdatas[0][3], scale, softmax)

    # ---- packed: the public entry, then each K7 tile forced ----
    for blk in JAX_BLOCKS:
        res = {"layout": "packed", "block": blk, "applicable": False,
               "reason": f"K7 takes query tiles of {[t[0] for t in K7_TILES]} rows over {FWD_BLOCK_K}-key tiles"}
        print(json.dumps(res), flush=True)
        results.append(res)
    tiles = [None] + (list(K7_TILES) if dev.type == "cuda" else [])  # None: the kernel's own pick
    c = torch.tensor(scale * LOG2E, dtype=torch.bfloat16, device=dev)
    for tile in tiles:
        for softmax in ("max", "nomax_clip"):
            if tile is None:
                def run(q, k, v, seg):
                    return packed_flash_attention(q, k, v, seg, scale=scale, softmax=softmax)
                datas = pdatas
            else:
                def run(q_pre, k, v, seg):
                    return _packed_fwd_cuda(q_pre, k, v, seg, softmax == "nomax_clip", False, block_q=tile[0])[0]
                datas = [(q * c, k, v, seg) for q, k, v, seg in pdatas]
            dt, out = _time_passes(run, datas, reps, dev)
            res = {"layout": "packed", "block": "default" if tile is None else list(tile), "softmax": softmax,
                   "batches": len(datas), "wall_ms": round(dt * 1e3, 2),
                   "tfs_true": round(true_flops / dt / 1e12, 1), "finite": bool(torch.isfinite(out).all())}
            if tile is not None:
                exec_pairs = acc["band_exec_pairs"][tile]
                res.update(tfs_exec=round(4.0 * H * D * exec_pairs / dt / 1e12, 1),
                           band_overhead=round(exec_pairs / acc["true_pairs"] - 1.0, 3))
            else:
                trace_path = os.path.join(trace, f"bench_packed_kernel_{softmax}.json") if trace else None
                with ProfiledWindow(dev, f"bench_packed_kernel packed {softmax} pass", trace_path) as w:
                    for d in datas:
                        run(*d)
                if windows is not None:
                    windows.append(w)
                res["pass_device_ms"] = w.summary["kernel_us"] / 1e3 if dev.type == "cuda" else None
            print(json.dumps(res), flush=True)
            results.append(res)

    # ---- bucketed baseline (512 quantum) on the same events ----
    exec_pairs = acc["bucket_exec_pairs"]
    for softmax in ("max", "nomax_clip"):
        def run(q, k, v, valid):
            return masked_flash_attention(q, k, v, valid, valid, scale, softmax)

        for d in bdatas:  # the JAX script warms every batch twice
            run(*d)
        dt, out = _time_passes(run, bdatas, reps, dev)
        res = {"layout": f"bucketed{QUANTUM}", "softmax": softmax, "batches": len(bdatas),
               "wall_ms": round(dt * 1e3, 2), "tfs_true": round(true_flops / dt / 1e12, 1),
               "tfs_exec": round(4.0 * H * D * exec_pairs / dt / 1e12, 1),
               "pad_overhead": round(exec_pairs / acc["true_pairs"] - 1.0, 3),
               "finite": bool(torch.isfinite(out).all())}
        print(json.dumps(res), flush=True)
        results.append(res)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--rows", type=int, default=12)
    ap.add_argument("--S", type=int, default=5120)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(RUNS_DIR, "packed_kernel_bench.json"))
    args = ap.parse_args(argv)
    from ..utils.hostmem import ensure_tuned

    ensure_tuned()  # glibc malloc tunables, by one re-exec of this command
    dev = measure_device(args.device)
    print(device_line(dev), flush=True)
    kw = dict(reps=args.reps, rows=args.rows, S=args.S, seed=args.seed)
    if dev.type == "cpu":
        kw.update(TINY)
    results = bench(dev, **kw)
    print("wrote", write_json(args.out, {"card": device_line(dev), "results": results}), flush=True)
    return results


if __name__ == "__main__":
    main()
