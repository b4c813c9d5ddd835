"""SR training throughput: bucketed against segment-packed batches.

Counterpart of the JAX package's ``scripts/bench_packed_train.py``, with its
flags, defaults and JSON line (``sr_train_events_per_sec``).  One pass of
real train steps (forward, backward, AdamW; bf16 compute, fp32 parameters,
per-layer remat; ``--fused`` for the fused DiT layer kernels) over the bench
multipart events, through the same ``SRTrainer.train_step``; only the batch
layout differs:

  * bucketed: ``BucketBatcher`` with the 512-cell quantum, the cost budget
    sum n^2 < 3520^2 * 6 and at most 64 events a batch (K1 with LSE, K5, K6);
  * packed: ``pack_events`` into (8, 6144) rows (K7 with LSE, K8, K9 and the
    band table).

The events are ``GeneratorConfig(res_factor=4, max_particles=4,
window_lr_cells=2)`` from seed 42, made in memory (the JAX script writes
them to an HDF5 file first).  Each leg starts from a copy of the same
initial weights and optimizer state, warms each batch shape with two steps
(as the JAX script), then times one step per batch, every event trained
exactly once, with one synchronisation at the end.  After its pass each leg
runs one ``loss_and_grads`` (no update) under ``checked()`` (``chip_smoke.py``
passes its launch checker) and one more under ``torch.profiler``
(``tools/trace_summary.py``).

    python -m superresolutionhep_tpu_torch.scripts.bench_packed_train [--S 6144] [--rows 8] [--quantum 512]
        [--cost-budget N] [--max-batch 64] [--n-events 256] [--fused] [--device cuda]

Prints the card's name and power limit, then the JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..configs import MULTIPART_CONFIG_MV
from ..data.bucketing import BucketBatcher
from ..data.packing import aligned_len, collate_packed, pack_events
from ..data.sr_dataset import SupResEvents, collate
from ..data.synthetic import GeneratorConfig, generate_events
from ..ops.flash_packed import PACKED_DEFAULTS, set_packed_defaults
from ..tools.trace_summary import ProfiledWindow
from ..train.sr_trainer import SRTrainer
from .common import RUNS_DIR, device_line, measure_device, sync, tiny_config_mv, write_json

GEN = dict(res_factor=4, max_particles=4, window_lr_cells=2)  # the bench multipart distribution
N_BENCH_EVENTS, SEED = 256, 42


TINY = {"S": 1024, "rows": 2, "n_events": 8, "gen": dict(res_factor=4, max_particles=1, window_lr_cells=1)}


def bench_events(config_mv, n_events=N_BENCH_EVENTS, gen=GEN, seed=SEED):
    """The bench's events as an in-memory ``SupResEvents`` (the JAX script
    writes 256 and reads the first ``n_events``; the generator draws event by
    event, so those are the same events)."""
    trees = generate_events(n_events, seed=seed, config=GeneratorConfig(**gen))
    return SupResEvents.from_trees(trees["Low_Tree"], trees["High_Tree"], config_mv)


def run_leg(trainer, init, batches, name, dev, checked, windows):
    """Train one pass over ``batches`` (host dicts) from the state ``init``:
    two warm steps per new shape, then one timed step per batch; after it a
    checked and a profiled ``loss_and_grads`` on the first batch (after the
    pass: the initial adaLN gates are zero, and so is every attention
    gradient).  Returns (seconds, shapes, losses, the profiled window)."""
    trainer.load_state(copy.deepcopy(init))
    trainer.generator.manual_seed(0)
    dev_batches = [trainer._device_batch(hb) for hb in batches]
    seen = []
    for b in dev_batches:
        shape = tuple(b["eta"].shape)
        if shape not in seen:
            seen.append(shape)
            tc = time.time()
            for _ in range(2):
                trainer.train_step(b, lr=1e-3)
            sync(dev)
            print(f"[{name}] warmed {shape}: {time.time() - tc:.1f}s", file=sys.stderr, flush=True)
    t0 = time.time()
    losses = [trainer.train_step(b, lr=1e-3)["loss"] for b in dev_batches]
    sync(dev)
    dt = time.time() - t0
    with checked():
        trainer.loss_and_grads(dev_batches[0])
    with ProfiledWindow(dev, f"bench_packed_train {name} loss_and_grads") as w:
        trainer.loss_and_grads(dev_batches[0])
    if windows is not None:
        windows.append(w)
    return dt, seen, torch.stack(losses).float().cpu().numpy(), w


def bench(dev, S=6144, rows=8, quantum=512, cost_budget=3520 * 3520 * 6, max_batch=64, n_events=N_BENCH_EVENTS,
          fused=False, config_mv=MULTIPART_CONFIG_MV, gen=GEN, checked=contextlib.nullcontext, windows=None):
    ds = bench_events(config_mv, n_events, gen)
    counts = np.asarray(ds.cell_count_high)[:n_events]
    cfg_t = {"num_epochs": 1, "learningrate": 1e-3, "lr_scheduler": None, "remat": True,
             "fused_prologue": bool(fused), "n_event_displays": 0}
    with tempfile.TemporaryDirectory() as td:
        trainer = SRTrainer(config_mv, cfg_t, run_dir=td, dtype=torch.bfloat16, device=dev)
    init = copy.deepcopy(trainer.state())
    cache = {}

    def get_ev(i):
        if i not in cache:
            cache[i] = ds.get_event(int(i))
        return cache[i]

    # --- bucketed leg ---
    bb = BucketBatcher(counts, quantum=quantum, cost_budget=cost_budget, max_batch_size=max_batch,
                       shuffle=False, tail_shrink=True)
    plan = list(bb)
    bucketed = [collate([get_ev(i) if i >= 0 else None for i in idxs], bucket.pad_n) for idxs, bucket in plan]
    trained_b = sorted(int(i) for idxs, _ in plan for i in idxs if i >= 0)
    dt_b, shapes_b, loss_b, w_b = run_leg(trainer, init, bucketed, "bucketed", dev, checked, windows)

    # --- packed leg ---
    saved = PACKED_DEFAULTS["max_segment_len"]
    set_packed_defaults(max_segment_len=aligned_len(int(counts.max())))
    try:
        layouts = pack_events(counts, S=S, rows_per_batch=rows)
        packed = [collate_packed({i: get_ev(i) for r in lay.rows for i, _, _ in r}, lay, S=S) for lay in layouts]
        trained_p = sorted(i for lay in layouts for r in lay.rows for i, _, _ in r)
        dt_p, shapes_p, loss_p, w_p = run_leg(trainer, init, packed, "packed", dev, checked, windows)
    finally:
        set_packed_defaults(max_segment_len=saved)

    n = len(counts)
    result = {
        "metric": "sr_train_events_per_sec",
        "n_events": n,
        "bucketed": {"wall_s": round(dt_b, 3), "events_per_sec": round(n / dt_b, 2), "n_batches": len(bucketed),
                     "n_shapes": len(shapes_b)},
        "packed": {"wall_s": round(dt_p, 3), "events_per_sec": round(n / dt_p, 2), "n_batches": len(packed),
                   "n_shapes": len(shapes_p), "S": S, "rows": rows},
        "packed_speedup": round(dt_b / dt_p, 3),
        "fused": bool(fused),
        "shapes": {"bucketed": [list(s) for s in shapes_b], "packed": [list(s) for s in shapes_p]},
        "losses": {"bucketed": [float(x) for x in loss_b], "packed": [float(x) for x in loss_p]},
        "losses_finite": bool(np.isfinite(loss_b).all() and np.isfinite(loss_p).all()),
        "events_trained_once": trained_b == list(range(n)) and trained_p == list(range(n)),
        # device time of a loss_and_grads on each leg's first batch (not measured on the CPU)
        "step_device_ms": {"bucketed_first_batch": w_b.summary["kernel_us"] / 1e3 if dev.type == "cuda" else None,
                           "packed_first_batch": w_p.summary["kernel_us"] / 1e3 if dev.type == "cuda" else None},
    }
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--S", type=int, default=6144)
    ap.add_argument("--rows", type=int, default=8)
    ap.add_argument("--quantum", type=int, default=512)
    ap.add_argument("--cost-budget", type=int, default=3520 * 3520 * 6)
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--n-events", type=int, default=N_BENCH_EVENTS, help="use the first N bench events")
    ap.add_argument("--fused", action="store_true",
                    help="train with the fused DiT layer kernels (plain recompute backward)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(RUNS_DIR, "packed_train_bench.json"))
    args = ap.parse_args(argv)
    from ..utils.hostmem import ensure_tuned

    ensure_tuned()  # glibc malloc tunables, by one re-exec of this command
    dev = measure_device(args.device)
    print(device_line(dev), flush=True)
    kw = dict(S=args.S, rows=args.rows, quantum=args.quantum, cost_budget=args.cost_budget,
              max_batch=args.max_batch, n_events=args.n_events, fused=args.fused)
    if dev.type == "cpu":
        kw.update(TINY, config_mv=tiny_config_mv())
    result = bench(dev, **kw)
    print(json.dumps({k: result[k] for k in ("metric", "n_events", "bucketed", "packed", "packed_speedup")}),
          flush=True)
    print("wrote", write_json(args.out, dict(result, card=device_line(dev))), flush=True)
    return result


if __name__ == "__main__":
    main()
