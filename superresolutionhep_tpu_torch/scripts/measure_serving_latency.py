"""Online-serving latency of ``SRServer`` at the production sampler settings.

Counterpart of the JAX package's ``scripts/measure_serving_latency.py``, with
its flags, event sizes and table: per bucket the p50/p95 latency of single
requests at six event sizes (the first two requests of each size dropped),
then two concurrent-client legs, a mid-size event (1900 cells, above the
batching bucket: FIFO) and a small one (480 cells, batched).  Weights are
random from a seed (latency does not depend on their values); the settings
are the production ones (``configs.py::serve_inference_config``: 25-point
grid, 10 members, ``ab2e``, bf16, fused prologue, the no-max kernel behind
its first-request self-check).  The first real request runs under
``checked()`` (``chip_smoke.py`` passes its launch checker).  Each request's
``device_ms`` is the server's own host clock around the sampler call.
``sampler_calls`` counts the calls the server made (a group of concurrent
requests shares one).

    python -m superresolutionhep_tpu_torch.scripts.measure_serving_latency [--reps 12] [--concurrency 4] [--device cuda]

Prints the card's name and power limit, then one line per size and the table.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import threading
import time

import numpy as np

from .common import RUNS_DIR, device_line, measure_device, write_json

SIZES = [200, 480, 1000, 1900, 3400, 4900]
TINY = {"sizes": [200, 480], "concurrent": ((480, 7), (200, 11)), "buckets": (256, 512, 1024)}  # --device cpu


def synth_event(n_cells: int, seed: int = 0, res_factor: int = 4) -> dict:
    """Build one serving request in the SRServer contract: a ``{"low": ...,
    "high": ...}`` pair (inference/server.py) with ECAL-only LR cells,
    rf^2 HR children per LR cell in canonical order, and an identity
    ``high_cell_to_low_cell_edge`` reorder map.  The HR ECAL cell count
    (what the server buckets on) is ``ceil(n_cells / rf^2) * rf^2``.

    Energies are a shower-like core+tail profile in MeV so the transform
    statistics and the no-max saturation gate see realistic magnitudes.
    The JAX script's function, array for array.
    """
    rng = np.random.default_rng(seed)
    rf2 = res_factor * res_factor
    n_lr = max(1, -(-n_cells // rf2))

    # LR cells on a square eta-phi patch, layers 0-2 (ECAL), radial shower
    # profile in energy (core cells ~GeV, tail cells ~MeV)
    side = int(np.ceil(np.sqrt(n_lr)))
    d_eta = 0.025
    idx = np.arange(n_lr)
    ie, ip = idx // side, idx % side
    eta = -0.5 * side * d_eta + (ie + 0.5) * d_eta + rng.uniform(-0.3, 0.3)
    phi = -0.5 * side * d_eta + (ip + 0.5) * d_eta + rng.uniform(-0.5, 0.5)
    layer = (idx % 3).astype(int)
    r2 = (ie - side / 2.0) ** 2 + (ip - side / 2.0) ** 2
    e_lr = 2000.0 * np.exp(-r2 / (2 * (side / 6.0 + 1e-6) ** 2))
    e_lr = np.maximum(e_lr * np.abs(1 + 0.2 * rng.normal(size=n_lr)), 1.0)  # MeV

    radii = np.array([1500.0, 1600.0, 1700.0])
    r = radii[layer]

    def _xyz(r_, eta_, phi_):
        th = 2 * np.arctan(np.exp(-eta_))
        return r_ * np.cos(phi_), r_ * np.sin(phi_), r_ / np.tan(th)

    x, y, z = _xyz(r, eta, phi)
    low = {
        "cell_eta": eta.tolist(), "cell_phi": phi.tolist(),
        "cell_layer": layer.tolist(), "cell_e": e_lr.tolist(),
        "cell_x": x.tolist(), "cell_y": y.tolist(), "cell_z": z.tolist(),
    }

    # HR children: rf x rf subgrid per LR cell, canonical order (children of
    # LR cell k occupy HR slots k*rf2 .. k*rf2+rf2-1) -> identity reorder map
    d_hr = d_eta / res_factor
    off = (np.arange(rf2) // res_factor + 0.5) * d_hr - 0.5 * d_eta
    offp = (np.arange(rf2) % res_factor + 0.5) * d_hr - 0.5 * d_eta
    eta_h = (eta[:, None] + off[None, :]).ravel()
    phi_h = (phi[:, None] + offp[None, :]).ravel()
    layer_h = np.repeat(layer, rf2)
    xh, yh, zh = _xyz(radii[layer_h], eta_h, phi_h)
    high = {
        "cell_eta": eta_h.tolist(), "cell_phi": phi_h.tolist(),
        "cell_layer": layer_h.tolist(),
        "cell_x": xh.tolist(), "cell_y": yh.tolist(), "cell_z": zh.tolist(),
    }
    low["high_cell_to_low_cell_edge"] = list(range(n_lr * rf2))
    return {"low": low, "high": high}


def make_server(dev, inf_cfg=None, **kw):
    """An ``SRServer`` with the production settings and random weights from seed 0."""
    from ..configs import serve_inference_config
    from ..inference.server import SRServer
    from ..tools.convert import init_params_jax_layout, params_from_jax

    inf_cfg = inf_cfg or serve_inference_config()
    fm = inf_cfg["model"]["config_mv"]["flow_model"]
    params = params_from_jax(init_params_jax_layout(fm, seed=0), fm)
    return SRServer(inf_cfg, params=params, device=dev, **kw)


def measure(server, reps=12, concurrency=4, sizes=SIZES, concurrent=((1900, 7), (480, 11)),
            checked=contextlib.nullcontext):
    """The JAX script's table on a built server (warm-up included)."""
    t0 = time.time()
    # single-row shapes for the whole latency table; multi-row shapes for the
    # batched bucket of the concurrent legs
    server.warmup(batch_sizes=(1,))
    rows = sorted({server._row_size(n) for n in range(2, server.max_batch + 1)})
    batched = [b for b in (512, 2048) if b in server.buckets]
    server.warmup(batch_sizes=rows, buckets=batched)
    table = {"warmup_s": round(time.time() - t0, 1), "warmup_sampler_calls":
             len(server.buckets) + len(rows) * sum(b <= server.batch_max_bucket for b in batched),
             "buckets": {}}
    with checked():
        first = server.predict_event(synth_event(sizes[0], seed=sizes[0]))
    calls = 1
    for n in sizes:
        ev = synth_event(n, seed=n)
        lat = []
        for _ in range(reps):
            t0 = time.time()
            out = server.predict_event(ev)
            lat.append((time.time() - t0) * 1e3)
        calls += reps
        lat = np.asarray(lat[2:])  # drop the straggler warm-up pair
        table["buckets"][str(n)] = {
            "bucket": out["bucket"],
            "p50_ms": round(float(np.percentile(lat, 50)), 1),
            "p95_ms": round(float(np.percentile(lat, 95)), 1),
            "device_ms": out["device_ms"],
            "finite": bool(np.isfinite(out["e_pred_raw"]).all()) and len(out["e_pred_raw"]) == out["n_cells"],
        }
        print(n, table["buckets"][str(n)], flush=True)

    def concurrent_leg(n_cells, seed):
        ev = synth_event(n_cells, seed=seed)
        done, batched_with, errors = [], [], []
        lock = threading.Lock()

        def client(n_calls):
            try:
                for _ in range(n_calls):
                    t = time.time()
                    out = server.predict_event(ev)
                    with lock:
                        done.append((time.time() - t) * 1e3)
                        batched_with.append(out.get("batched_with", 1))
            except Exception as e:  # re-raised below: a failed request fails the run
                errors.append(e)

        t0 = time.time()
        threads = [threading.Thread(target=client, args=(reps,)) for _ in range(concurrency)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        dt = time.time() - t0
        if errors:
            raise errors[0]
        return {
            "n_cells": n_cells,
            "clients": concurrency,
            "events_per_sec": round(reps * concurrency / dt, 2),
            "p50_ms": round(float(np.percentile(done, 50)), 1),
            "p95_ms": round(float(np.percentile(done, 95)), 1),
            "mean_batched_with": round(float(np.mean(batched_with)), 2),
            "max_batch": server.max_batch,
            "batch_window_ms": server.batch_window_ms,
            # a group of g requests reports batched_with = g from each member
            "sampler_calls": int(round(sum(1.0 / b for b in batched_with))),
        }

    (n_mid, s_mid), (n_small, s_small) = concurrent
    table["concurrent"] = concurrent_leg(n_mid, s_mid)
    table["concurrent_small"] = concurrent_leg(n_small, s_small)
    table["sampler_calls"] = calls + table["concurrent"]["sampler_calls"] + table["concurrent_small"]["sampler_calls"]
    table["first_request"] = {"bucket": first["bucket"], "selfcheck_passed": server.inf.nomax_selfcheck_passed,
                              "fast_softmax": server.inf.fast_softmax}
    return table


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=12)
    ap.add_argument("--concurrency", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(RUNS_DIR, "serving_latency.json"))
    args = ap.parse_args(argv)
    from ..utils.hostmem import ensure_tuned

    ensure_tuned()  # glibc malloc tunables, by one re-exec of this command
    dev = measure_device(args.device)
    print(device_line(dev), flush=True)
    kw = {}
    if dev.type == "cpu":
        from ..configs import serve_inference_config
        from .common import tiny_config_mv

        server = make_server(dev, serve_inference_config(tiny_config_mv(), n_steps=3), buckets=TINY["buckets"])
        kw = {"sizes": TINY["sizes"], "concurrent": TINY["concurrent"]}
    else:
        server = make_server(dev)
    table = measure(server, args.reps, args.concurrency, **kw)
    print(json.dumps(table, indent=2), flush=True)
    print("wrote", write_json(args.out, dict(table, card=device_line(dev))), flush=True)
    return table


if __name__ == "__main__":
    main()
