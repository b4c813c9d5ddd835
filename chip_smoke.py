#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``superresolutionhep_tpu_torch/
csrc`` with nvcc, holds each kernel against its plain PyTorch version on the
card, then drives the port's main path — ``SRServer.predict_event`` at the
full width of the multi-particle model (h=256, 6 DiT layers, 4 heads of 64,
25-point grid, 10 ensemble members, bf16, no-max attention, fused prologue) —
and checks from the launch counters that the requests really went through the
kernels.  Weights are random (seeded); events are synthetic (seeded).

Output: one JSON object per phase on a line of its own (``device``, ``build``,
``kernel_case`` lines, ``serve``), then the card's name and power limit as
nvidia-smi gives them, then ``{"kernels": [...]}`` (one entry per kernel: its
time on the card, the plain version's, the bound, the launches on the main
path), then, last, ``{"ok": true, "device": {...}}``.  Any failure exits
non-zero and prints no ``ok`` line.  Without a CUDA device it exits 2.

Options (for development; the default run does everything):
    --skip-serve      kernels only
    --ptxas           print nvcc's per-kernel register/shared-memory report
    --reps N          timed launches per kernel case (default 20)
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12
H100_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense tensor-core bf16; fp32 outside them

# tolerances against the plain version on the card, with their reasons
TOL = {
    # fp32: same arithmetic, another summation order (tiles of 32/64 keys, FMA chains)
    ("flash", torch.float32): 2e-4,
    ("fused", torch.float32): 1e-4,
    # bf16: inputs and P rounded to 8 bits of mantissa, output rounded once more;
    # the bound the bf16 golden of the JAX package is held to
    ("flash", torch.bfloat16): 3e-2,
    ("fused", torch.bfloat16): 3e-2,
    # no-max kernel against the ROBUST plain version: nomax_selfcheck's own bound
    ("nomax_vs_robust", torch.bfloat16): 6e-2,
    ("lse", torch.float32): 1e-3,
    ("lse", torch.bfloat16): 2e-2,
}

REPLACES = {
    "flash_fwd": "superresolutionhep_tpu/ops/flash_attention.py:213",
    "flash_fwd_nomax": "superresolutionhep_tpu/ops/flash_attention.py:291",
    "fused_qkv": "superresolutionhep_tpu/ops/fused_qkv.py:116",
    "fused_mlp": "superresolutionhep_tpu/ops/fused_mlp.py:141",
}
SOURCE = {
    "flash_fwd": "superresolutionhep_tpu_torch/csrc/flash_attention.cu",
    "flash_fwd_nomax": "superresolutionhep_tpu_torch/csrc/flash_attention.cu",
    "fused_qkv": "superresolutionhep_tpu_torch/csrc/fused_qkv.cu",
    "fused_mlp": "superresolutionhep_tpu_torch/csrc/fused_mlp.cu",
}


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps, inner=8):
    """Device time of one call of ``fn`` in ms: ``inner`` calls are captured into
    a CUDA graph, the graph is replayed ``reps`` times, each replay between its
    own pair of CUDA events, and the median is divided by ``inner``.  Replaying a
    graph takes the host out of the interval: timed eagerly, a 20 us kernel
    behind a 100 us Python wrapper reads as 100 us."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up (first-launch set-up must not be captured)
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    del graph
    return statistics.median(times)


def ragged_valid(B, L, device):
    """(B, L) True==valid masks with ragged lengths: full rows, rows that end
    inside a tile, rows whose last tiles are fully padded, one empty row."""
    fracs = [1.0, 0.98, 0.75, 0.6, 0.502, 0.26, 0.2, 0.125, 0.002, 0.0]
    lens = [min(L, max(0, int(round(fracs[i % len(fracs)] * L)))) for i in range(B)]
    lens[8 % B] = 1 if B > 8 else lens[8 % B]
    valid = torch.arange(L, device=device)[None, :] < torch.tensor(lens, device=device)[:, None]
    return valid, lens


# ---------------------------------------------------------------------------
# phase: kernels
# ---------------------------------------------------------------------------


def kernel_cases(reps):
    from superresolutionhep_tpu_torch.ops import flash_attention as fa
    from superresolutionhep_tpu_torch.ops import fused_mlp as fm
    from superresolutionhep_tpu_torch.ops import fused_qkv as fq
    from superresolutionhep_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    B, H, D, F, Fh = 10, 4, 64, 256, 256
    g = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        dname = "bf16" if dtype == torch.bfloat16 else "fp32"
        for L in (512, 2048):
            valid, lens = ragged_valid(B, L, dev)
            isz = 2 if dtype == torch.bfloat16 else 4
            peak = H100_FLOPS[dtype]

            # ---- K1 / K2: attention, inputs in the layout the fused prologue emits
            qkv = randn(B, L, 3 * F, scale=1.0, dtype=torch.float32)
            qkv[..., :F] *= 0.5  # base-2 logits with std ~4: well inside the clip bounds
            qkvT = qkv.to(dtype).transpose(1, 2).reshape(B, 3, H, D, L)
            qT, kT, vT = qkvT[:, 0], qkvT[:, 1], qkvT[:, 2]
            qh, kh, vh = (t.permute(0, 1, 3, 2) for t in (qT, kT, vT))  # (B,H,L,D) for the plain version
            qm = valid.float()[:, None]
            flops = 4.0 * H * D * sum(n * n for n in lens)  # what these masks need, not 4*B*H*L*L*D
            nbytes = 4 * B * H * L * D * isz + 2 * B * L * 4
            robust_ref = None
            for name, softmax in (("flash_fwd", "max"), ("flash_fwd_nomax", "nomax_clip")):
                with_lse = softmax == "max"
                before = kernels.LAUNCHES[name]
                res = fa.masked_flash_attention_T(qT, kT, vT, valid, valid, softmax=softmax, with_lse=with_lse)
                torch.cuda.synchronize()
                if kernels.LAUNCHES[name] != before + 1:
                    fail(f"{name}: the wrapper did not count its launch")
                outT, lse = res if with_lse else (res, None)
                ref = fa._ref_attention_base2(qh, kh, vh, qm, qm, softmax, with_lse=with_lse)
                ref_out, ref_lse = ref if with_lse else (ref, None)
                out = outT.permute(0, 1, 3, 2).float()
                err = (out - ref_out.float()).abs().max().item()
                tol = TOL[("flash", dtype)]
                case = {"kernel": name, "dtype": dname, "B": B, "H": H, "L": L, "D": D,
                        "max_abs_err": err, "tol": tol}
                ok = bool(torch.isfinite(out).all()) and err <= tol
                if with_lse:
                    vq = valid[:, None, :].expand(B, H, L)
                    lerr = (lse[:, :, 0, :] - ref_lse)[vq].abs().max().item()
                    case["lse_max_abs_err"], case["lse_tol"] = lerr, TOL[("lse", dtype)]
                    ok = ok and lerr <= TOL[("lse", dtype)]
                    robust_ref = ref_out.float()
                elif dtype == torch.bfloat16:
                    # what nomax_selfcheck relies on: no-max kernel vs the robust formulation
                    xerr = (out - robust_ref).abs().max().item()
                    case["vs_robust_max_abs_err"], case["vs_robust_tol"] = xerr, TOL[("nomax_vs_robust", dtype)]
                    ok = ok and xerr <= TOL[("nomax_vs_robust", dtype)]
                # padded query rows must be exactly zero
                ok = ok and float(out.permute(0, 2, 1, 3)[~valid].abs().max() if (~valid).any() else 0.0) == 0.0
                case["ms"] = time_ms(
                    lambda: fa.masked_flash_attention_T(qT, kT, vT, valid, valid, softmax=softmax, with_lse=with_lse), reps)
                case["plain_ms"] = time_ms(
                    lambda: fa._ref_attention_base2(qh, kh, vh, qm, qm, softmax, with_lse=with_lse), max(3, reps // 5))
                # yardstick only (the port never calls it): one SDPA call on the same
                # inputs; base-2 logits -> scale ln2; key-padding mask
                qc, kc, vc = (t.contiguous() for t in (qh, kh, vh))
                amask = valid[:, None, None, :]
                case["library_ms"] = time_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(qc, kc, vc, attn_mask=amask, scale=fa.LN2),
                    reps)
                case["bound_ms"] = max(flops / peak, nbytes / H100_BYTES_PER_S) * 1e3
                case["bound_by"] = "operations" if flops / peak >= nbytes / H100_BYTES_PER_S else "bytes"
                case["ok"] = ok
                cases.append(case)
                emit({"phase": "kernel_case", **case})

            # ---- K3: LN + modulate + QKV projection (per-batch rows; per-cell rows at L=512)
            x = randn(B, L, F, dtype=dtype)
            w_t = randn(3 * F, F, scale=0.03, dtype=dtype)  # (O, F) as a Linear weight; w = its transposed view
            bias = randn(3 * F, scale=0.1)
            for per_cell in ((False, True) if L == 512 else (False,)):
                shape = (B, L, F) if per_cell else (B, F)
                ea, eb = 1.0 + randn(*shape, scale=0.1), randn(*shape, scale=0.1)
                out = fq.fused_ln_mod_proj(x, ea, eb, w_t.t(), bias)
                torch.cuda.synchronize()
                ref = fq._ref_ln_mod_proj(x, ea, eb, w_t.t(), bias)
                err = (out.float() - ref.float()).abs().max().item()
                tol = TOL[("fused", dtype)]
                flops3 = 2.0 * B * L * F * 3 * F
                bytes3 = (B * L * F + B * L * 3 * F + 3 * F * F) * isz + (2 * ea.numel() + 3 * F) * 4
                case = {"kernel": "fused_qkv", "dtype": dname, "B": B, "L": L, "F": F, "O": 3 * F,
                        "per_cell": per_cell, "max_abs_err": err, "tol": tol,
                        "ms": time_ms(lambda: fq.fused_ln_mod_proj(x, ea, eb, w_t.t(), bias), reps),
                        "plain_ms": time_ms(lambda: fq._ref_ln_mod_proj(x, ea, eb, w_t.t(), bias), max(3, reps // 5)),
                        "library_ms": None,
                        "bound_ms": max(flops3 / peak, bytes3 / H100_BYTES_PER_S) * 1e3,
                        "bound_by": "operations" if flops3 / peak >= bytes3 / H100_BYTES_PER_S else "bytes",
                        "ok": bool(torch.isfinite(out.float()).all()) and err <= tol}
                cases.append(case)
                emit({"phase": "kernel_case", **case})

            # ---- K4: MLP half-layer
            q = randn(B, L, F, scale=0.5, dtype=dtype)
            att = randn(B, L, F, scale=0.5, dtype=dtype)
            w0_t = randn(Fh, F, scale=0.06, dtype=dtype)
            w1_t = randn(F, Fh, scale=0.06, dtype=dtype)
            b0, b1 = randn(Fh, scale=0.1), randn(F, scale=0.1)
            for per_cell in ((False, True) if L == 512 else (False,)):
                shape = (B, L, F) if per_cell else (B, F)
                ga, gm = randn(*shape, scale=0.5), randn(*shape, scale=0.5)
                ea, eb = 1.0 + randn(*shape, scale=0.1), randn(*shape, scale=0.1)
                args = (q, att, ga, ea, eb, gm, w0_t.t(), b0, w1_t.t(), b1)
                out = fm.fused_dit_mlp(*args)
                torch.cuda.synchronize()
                ref = fm._ref_dit_mlp(*args)
                err = (out.float() - ref.float()).abs().max().item()
                tol = TOL[("fused", dtype)]
                flops4 = 4.0 * B * L * F * Fh
                bytes4 = (3 * B * L * F + 2 * F * Fh) * isz + (4 * ga.numel() + F + Fh) * 4
                case = {"kernel": "fused_mlp", "dtype": dname, "B": B, "L": L, "F": F, "Fh": Fh,
                        "per_cell": per_cell, "max_abs_err": err, "tol": tol,
                        "ms": time_ms(lambda: fm.fused_dit_mlp(*args), reps),
                        "plain_ms": time_ms(lambda: fm._ref_dit_mlp(*args), max(3, reps // 5)),
                        "library_ms": None,
                        "bound_ms": max(flops4 / peak, bytes4 / H100_BYTES_PER_S) * 1e3,
                        "bound_by": "operations" if flops4 / peak >= bytes4 / H100_BYTES_PER_S else "bytes",
                        "ok": bool(torch.isfinite(out.float()).all()) and err <= tol}
                cases.append(case)
                emit({"phase": "kernel_case", **case})

    # the PF stage's head dim (16) must build and agree too: one small robust case
    valid, _ = ragged_valid(4, 256, dev)
    t16 = randn(4, 256, 3, 4, 16, scale=0.7).to(torch.bfloat16)
    q16, k16, v16 = t16[:, :, 0], t16[:, :, 1], t16[:, :, 2]  # (B, L, H, 16) strided views
    out16 = fa.masked_flash_attention(q16, k16, v16, valid, valid, scale=0.25)
    ref16, _ = fa._ref_attention(*(t.permute(0, 2, 1, 3) for t in (q16, k16, v16)),
                                 valid.float()[:, None], valid.float()[:, None], 0.25)
    err16 = (out16.float() - ref16.permute(0, 2, 1, 3).float()).abs().max().item()
    case = {"kernel": "flash_fwd", "dtype": "bf16", "B": 4, "H": 4, "L": 256, "D": 16,
            "max_abs_err": err16, "tol": TOL[("flash", torch.bfloat16)], "ok": err16 <= TOL[("flash", torch.bfloat16)]}
    cases.append(case)
    emit({"phase": "kernel_case", **case})

    bad = [c for c in cases if not c["ok"]]
    if bad:
        fail(f"{len(bad)} kernel case(s) disagree with the plain version: "
             + "; ".join(f"{c['kernel']}/{c['dtype']}/L={c['L']} err={c['max_abs_err']:.3g} tol={c['tol']}" for c in bad))
    return cases


# ---------------------------------------------------------------------------
# phase: serve
# ---------------------------------------------------------------------------


def make_requests():
    """Synthetic events as /predict request dicts, keyed by a label."""
    from superresolutionhep_tpu_torch.data.sr_dataset import N_ECAL_LAYERS
    from superresolutionhep_tpu_torch.data.synthetic import GeneratorConfig, generate_events
    from superresolutionhep_tpu_torch.inference.server import LOW_KEYS

    def requests(n, seed, **kw):
        trees = generate_events(n, seed=seed, config=GeneratorConfig(res_factor=4, **kw))
        low, high = trees["Low_Tree"], trees["High_Tree"]
        out = []
        for i in range(n):
            ev = {
                "low": {k: np.asarray(low[k][i]).tolist() for k in LOW_KEYS},
                "high": {k: np.asarray(high[k][i]).tolist() for k in LOW_KEYS if k != "cell_e"},
            }
            ev["low"]["high_cell_to_low_cell_edge"] = np.asarray(low["high_cell_to_low_cell_edge"][i]).tolist()
            n_cells = int((np.asarray(high["cell_layer"][i]) < N_ECAL_LAYERS).sum())
            out.append((n_cells, ev))
        return out

    pool = (
        requests(3, 7, min_particles=1, max_particles=1, window_lr_cells=1)      # ~430 cells
        + requests(3, 8, min_particles=2, max_particles=2, window_lr_cells=1)    # ~860 cells
        + requests(3, 9, min_particles=1, max_particles=1, window_lr_cells=2)    # ~1200 cells
        + requests(3, 10, min_particles=2, max_particles=2, window_lr_cells=2)   # ~2400 cells
        # the multi-particle benchmark mix: ~1.2k-4.8k cells
        + requests(6, 42, max_particles=4, window_lr_cells=2)
    )

    def pick(lo, hi, k):
        got = [r for r in pool if lo < r[0] <= hi][:k]
        if len(got) < k:
            raise RuntimeError(f"synthetic pool has only {len(got)} events with {lo} < cells <= {hi}")
        return got

    return {"small": pick(0, 512, 2), "mid": pick(512, 1024, 1), "large": pick(1024, 2048, 1),
            "xlarge": pick(2048, 4096, 2)}


def serve_phase():
    from superresolutionhep_tpu_torch.configs import MULTIPART_CONFIG_MV, serve_inference_config
    from superresolutionhep_tpu_torch.inference.server import SRServer
    from superresolutionhep_tpu_torch.inference.sr import batch_to_device
    from superresolutionhep_tpu_torch.data.sr_dataset import MODEL_BATCH_KEYS, SupResEvents, collate
    from superresolutionhep_tpu_torch.inference.server import _event_to_trees
    from superresolutionhep_tpu_torch.ops import kernels
    from superresolutionhep_tpu_torch.tools.convert import init_params_jax_layout, params_from_jax

    flow_cfg = MULTIPART_CONFIG_MV["flow_model"]
    params = params_from_jax(init_params_jax_layout(flow_cfg, seed=0), flow_cfg)
    buckets = (512, 1024, 2048, 4096)
    reqs = make_requests()

    srv = SRServer(serve_inference_config(), buckets=buckets, params=params, device="cuda")
    t0 = time.time()
    srv.warmup()
    warm_s = time.time() - t0

    # ---- the counted window: every count to 0 just before, read just after
    kernels.reset_launches()
    results, errors = [], []

    def call(label, n_cells, ev):
        try:
            t = time.time()
            out = srv.predict_event(ev)
            results.append((label, n_cells, out, (time.time() - t) * 1e3))
        except Exception as e:  # re-raised below: a failed request fails the run
            errors.append((label, e))

    # 1: a lone small request (also carries the first-batch no-max selfcheck)
    call("small0", *reqs["small"][0])
    # 2: one event above batch_max_bucket runs FIFO; while the worker is busy with it,
    # 3+4: two small events arrive and must be grouped into ONE sampler call
    big = threading.Thread(target=call, args=("xlarge0", *reqs["xlarge"][0]))
    big.start()
    deadline = time.time() + 60
    while not srv._lock.locked() and big.is_alive() and time.time() < deadline:
        time.sleep(0.0005)
    pair = [threading.Thread(target=call, args=(f"pair{i}", *reqs["small"][i])) for i in range(2)]
    for th in pair:
        th.start()
    for th in [big, *pair]:
        th.join()
    # 5-7: the other buckets, one at a time
    call("mid0", *reqs["mid"][0])
    call("large0", *reqs["large"][0])
    call("xlarge1", *reqs["xlarge"][1])
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    # ---- end of the counted window

    if errors:
        fail(f"request {errors[0][0]} raised {type(errors[0][1]).__name__}: {errors[0][1]}")

    n_layers = int(flow_cfg["transformer"]["num_transformer_layers"])
    evals = srv.inf.n_steps - 1  # ab2e: one model evaluation per grid interval
    pair_out = [out for label, _, out, _ in results if label.startswith("pair")]
    n_calls = len(results) - (1 if all(o["batched_with"] == 2 for o in pair_out) else 0)
    per_call = n_layers * evals
    expect = {"flash_fwd": n_layers, "flash_fwd_nomax": per_call * n_calls + n_layers,
              "fused_qkv": per_call * n_calls + n_layers, "fused_mlp": per_call * n_calls + n_layers}

    checks = {
        "nomax_validated": bool(srv.inf._nomax_validated),
        "selfcheck_passed": srv.inf.nomax_selfcheck_passed is True and srv.inf.fast_softmax is True,
        "pair_batched": all(o["batched_with"] == 2 for o in pair_out),
        "fifo_above_batch_max_bucket": all(o["batched_with"] == 1 for _, _, o, _ in results if o["bucket"] > 1024),
        "all_finite_and_sized": all(
            len(o["e_pred_raw"]) == o["n_cells"] == n and bool(np.isfinite(o["e_pred_raw"]).all())
            for _, n, o, _ in results),
        "launch_counts": counts == expect,
        "every_kernel_launched": all(v > 0 for v in counts.values()),
    }

    # ---- the same request, the same seed, through the robust (fast_softmax: false) server
    robust = SRServer(serve_inference_config(fast_softmax=False), buckets=buckets, params=params, device="cuda")
    n_small, ev_small = reqs["small"][0]
    low, high = _event_to_trees(ev_small)
    ev = SupResEvents.from_trees(low, high, MULTIPART_CONFIG_MV).get_event(0)
    batch = batch_to_device(collate([ev], 512), torch.device("cuda"), MODEL_BATCH_KEYS)
    raw = {}
    for name, s in (("fast", srv), ("robust", robust)):
        gen = torch.Generator(device="cuda").manual_seed(1)
        with s._lock:
            traj = s.inf._gen(batch, gen, n_ensemble=s.n_ensemble, n_steps=s.inf.n_steps, method=s.method,
                              fast=s.inf.fast_softmax)
        raw[name] = traj[:, -1, 0, :n_small, 0].float().mean(0)  # raw_nn_pred: ensemble mean of the final state
    raw_diff = (raw["fast"] - raw["robust"]).abs().max().item()
    out_robust = robust.predict_event(ev_small)  # its request counter is 1, as the fast server's first
    out_fast = next(o for label, _, o, _ in results if label == "small0")
    e_f, e_r = np.asarray(out_fast["e_pred_raw"]), np.asarray(out_robust["e_pred_raw"])
    checks["robust_agrees_raw_nn_pred"] = raw_diff <= 6e-2 and bool(torch.isfinite(raw["robust"]).all())

    line = {
        "phase": "serve", "buckets": list(buckets), "n_requests": len(results), "sampler_calls": n_calls,
        "warmup_s": round(warm_s, 2),
        "requests": [{"label": label, "n_cells": n, "bucket": o["bucket"], "batched_with": o["batched_with"],
                      "device_ms": o["device_ms"], "total_ms": round(ms, 2)} for label, n, o, ms in results],
        "launches": counts, "launches_expected": expect,
        "launches_per_sampler_call": {"flash_fwd_nomax": per_call, "fused_qkv": per_call, "fused_mlp": per_call},
        "robust_vs_fast_raw_nn_pred_max_abs": raw_diff, "robust_vs_fast_tol": 6e-2,
        "robust_vs_fast_e_pred_raw_rel": float(np.abs(e_f - e_r).max() / max(np.abs(e_r).max(), 1e-12)),
        "checks": checks, "ok": all(checks.values()),
    }
    emit(line)
    if not line["ok"]:
        fail("serve checks failed: " + ", ".join(k for k, v in checks.items() if not v))
    return counts


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-serve", action="store_true")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        sys.exit(2)
    t_start = time.time()
    from superresolutionhep_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()})

    t0 = time.time()
    lib = kernels.build(verbose=args.ptxas)
    kernels.library()
    emit({"phase": "build", "library": str(lib.name), "seconds": round(time.time() - t0, 2),
          "nvcc_flags": list(kernels.NVCC_FLAGS)})
    if args.ptxas:
        print((kernels.build_dir() / "nvcc_log.txt").read_text(), flush=True)

    cases = kernel_cases(args.reps)
    counts = {k: 0 for k in kernels.LAUNCHES}
    if not args.skip_serve:
        counts = serve_phase()

    # one entry per kernel: the main path's shape class (bf16, L=2048, per-batch rows)
    entries = []
    for name in ("flash_fwd", "flash_fwd_nomax", "fused_qkv", "fused_mlp"):
        c = next(c for c in cases if c["kernel"] == name and c["dtype"] == "bf16" and c["L"] == 2048)
        entries.append({
            "name": name, "route": "cuda", "source": SOURCE[name], "replaces": REPLACES[name],
            "launches": counts[name], "max_abs_err": c["max_abs_err"], "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "shape": {k: c[k] for k in ("B", "H", "L", "D", "F", "O", "Fh") if k in c}, "dtype": "bf16",
        })
    emit({"phase": "total", "seconds": round(time.time() - t_start, 1)})
    print(smi, flush=True)
    emit({"kernels": entries})
    if args.skip_serve:
        fail("--skip-serve: the main path was not driven, so no ok line")
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
