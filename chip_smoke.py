#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``superresolutionhep_tpu_torch/
csrc`` with nvcc, holds each kernel against its plain PyTorch version on the
card (K1-K9 at the SR and PF shapes, K3/K4 also with the per-segment
modulation rows of the packed sampler's (80, 5120) batch, the attention
probes K10/K11 at the measuring scripts' shapes), runs the two ported
measuring scripts' own sweeps
(``scripts/kernel_experiments.py``, ``scripts/probe_exp_dtype.py`` of the
package; the probes phase), then drives the port's main paths at the full
width of the multi-particle model (h=256, 6 DiT layers, 4 heads of 64):
  * serve: ``SRServer.predict_event`` (25-point grid, 10 ensemble members,
    bf16, no-max attention, fused prologue);
  * packed inference: ``SRInference.predict`` with ``packed: true`` (rows of
    5120 cells, 8 a batch; the fast and the robust model; the bucketed
    mop-up of events longer than a row; a packed row against the same events
    unpacked);
  * train: ``SRTrainer.fit`` (bf16 compute, fp32 parameters, per-layer remat,
    unfused, dopri5 validation, checkpoints, resume), flash-vs-dense and
    fused-vs-unfused gradients in fp32, train-step times;
  * dopri5 ensemble: ``generate_ensemble(method="dopri5")``, each member
    against the others' noise drawn anew and against its own run alone;
  * packed train: ``SRTrainer.fit`` with ``packed: true``, resumed; fp32
    gradients of a packed row against the same events unpacked; the step time
    at (8, 5120);
and stage 2 at the published particle-flow configuration (h 64, 3 encoder
DiT layers of 4 heads of 16, 4 cross-attention kinematics layers) on the
SR-predicted trees of 32 synthetic events:
  * pf inference: ``PFInference.predict`` at high and low resolution (fp32,
    batch 32); the K1 path against the dense path;
  * pf train: ``PFTrainer.fit`` (fp32, the published training settings),
    resumed; fp32 gradients through K1/K5/K6 against the dense path, a bf16
    step by its loss, step times on a fit batch and at the published bucket
    sizes;
then the shipped trained checkpoints, read from their Flax msgpack blobs:
  * trained: ``closure_sr`` (the multipart model with 9 Fourier geometry
    octaves) against its frozen goldens from the JAX sampler's noise
    (``tests/golden_torch/sr_golden_x0.npz``): fp32 ``ab2`` within the
    golden's tolerances, fp32 ``dopri5`` beside them; ``SRInference.predict``
    with the serving settings (bf16, ``ab2e``; on this checkpoint its gate
    takes the robust K1 path), its distances to fp32 and to the TPU-frozen
    golden beside their bound, its call time; the gate-rejected no-max fused
    path (K2, K3/K4) within a bound on its distance to that golden;
    ``closure_pf`` through K1 against the dense path;
and the second model family:
  * normformer: the ``GPT-2+Normformer`` FlowModel at the multipart width,
    fp32 and bf16 through K1, bf16 through K2, fp32 against the dense path;
in both, each launch of K1-K4 against its plain version on its own inputs,
and a control with a planted fault (each row's last 64-key tile masked out
in the attention kernels) that those checks must catch;
and parallelism on ``torch.distributed`` (always run, also under the skip
flags), ranks spawned from the phase at the multipart width:
  * parallel: at world size 1 over NCCL, ``SRTrainer.fit`` through the
    data-parallel code equal to the run with no process group bit for bit,
    a PF step likewise, the SP and TP forwards; at two ranks on the one card
    over gloo, a data-parallel ``SRTrainer`` step, the TP = 2 and SP = 2
    forwards and train steps against one rank in fp32, each rank's launches
    exact and its sharded K1 launches under the checker with its control;
  * parallel_pf: the same for the published PF model's sequence and tensor
    parallelism (fp32, an (8, 2048) batch; SP = 2 gather, TP = 2) and for both
    trainers' validation split over the data-parallel ranks (the multipart
    SR model at full width with a fixed-step sampler, the PF model), every
    K1/K5/K6 launch of the sharded paths and every K1 launch of the split
    validations under the checker;
and the shipped closure checkpoints on their suites' test events (always
run, also under the skip flags), in memory:
  * closure: ``closure_sr`` on the 256 events of ``closure_suite.GEN``
    (seed 13) through ``SRInference.predict`` with the suite's settings
    (robust K1, 10 members, ``ab2e`` at 25 points), in fp32 and with the
    bf16 stack, each iqr_ratio against the JAX package's reading in that
    precision on the same events (the cell count exact, the IQR ratio's
    gate, the ratio within 3% in fp32, 5% in bf16), the shipped
    ``saved_checkpoints/closure_sr/closure_metrics.json`` printed beside
    them; ``closure_pf`` on the PF
    suite's 256 events (seed 23) after its LR passthrough, through
    ``PFInference.predict``, against ``closure_pf_metrics.json`` (accuracy
    within 0.02, the residual IQRs and the incidence MAE within 10%); the
    fp32 K1 launches under the checker, an ill-conditioned one against fp64;
and checks from the launch counters, reset just before each path and read
just after, that they really went through the kernels.  Weights are random
(seeded) but for the trained phase; events are synthetic (seeded).

Output: one JSON object per phase on a line of its own (``device``, ``build``,
``ptxas`` (registers, spills and serialised wgmma of the bf16 forward,
backward and fused kernels and of the fp32 attention kernels; any spill or
serialisation fails the run),
``kernel_case`` lines (the bf16 backward also at head dims 16/32/64 and
both tile heights, launched twice and equal bit for bit; the fp32 attention
kernels at head dims 16/32/64 and on a guard at base-2 logits of std ~8,
where single-TF32 products would miss the fp32 bounds; launched twice,
equal bit for bit), the scripts' own
lines and ``probes``, ``serve``, ``packed_inference``, ``train``, ``dopri5_ensemble``, ``packed_train``,
``pf_inference``, ``pf_train``, ``trained``, ``normformer``, ``parallel``, ``parallel_pf``, ``closure``), then the card's name and power
limit as nvidia-smi gives them,
then ``{"kernels": [...]}`` (one entry per kernel, K1-K11: its time on the
card, the plain version's, the bound, the launches on the main paths; the
attention entries also their fp32 cases under ``fp32``), then,
last, ``{"ok": true, "device": {...}}``.  Any failure exits non-zero and
prints no ``ok`` line.  Without a CUDA device it exits 2.

Options (for development; the default run does everything):
    --skip-serve      no serve, packed and pf inference, trained and normformer phases (exits 1 by design)
    --skip-train      no train, dopri5 ensemble, packed and pf train phases (exits 1 by design)
                      (the parallel, parallel_pf and closure phases run under both)
    --ptxas           print nvcc's per-kernel register/shared-memory report
    --reps N          timed launches per kernel case (default 20)
    --closure-variants  after the build, only the SR closure's noise seeds, samplers and
                      precisions (``closure_variants``) and the card; no ok line
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12
H100_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense tensor-core bf16; fp32 outside them
H100_TF32_FLOPS = 495e12  # dense TF32 on the tensor cores
# the fp32 attention kernels take each product as three TF32 ones (lo*hi + hi*lo + hi*hi)
TF32_SPLIT_TERMS = 3

# tolerances against the plain version on the card, with their reasons
TOL = {
    # fp32: same arithmetic, another summation order (tiles of 32/64 keys; the
    # attention kernels' products as three-term TF32 splits, ~2^-21 of each)
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
    # backward kernels, error relative to each output's max: fp32 — the same
    # arithmetic in another summation order over up to 3584 keys; bf16 — P
    # and dS rounded to 8 bits of mantissa before their products, as in the
    # plain version, outputs rounded once more (the JAX package's bf16 bound)
    ("flash_bwd", torch.float32): 2e-4,
    ("flash_bwd", torch.bfloat16): 3e-2,
    # autograd through K1+K5+K6 against autograd through the dense
    # natural-base plain formulation, fp32, relative to each gradient's max
    ("flash_grad", torch.float32): 2e-4,
}
# the packed kernels K7-K9 are held to the same bounds as K1/K2/K5/K6, relative
# to each output's max (the LSE absolutely, at valid queries only).
# A packed row against the same events unpacked, one model evaluation: fp32
# relative to the output's max (the attention kernels' bound); bf16 absolute,
# nomax_selfcheck's model-level bound: the packed layout's per-cell modulation
# rows are fp32 (the one-hot scatter promotes) where the unpacked ones are
# bf16, and the JAX package's own bf16 gap between the two layouts on this
# model (6 layers, random weights) is 0.045 absolute, 3.2e-2 of the max.
LAYOUT_TOL = {torch.float32: ("rel", 2e-4), torch.bfloat16: ("abs", 6e-2)}
# the attention probes K10/K11 against their plain versions, relative to each
# output's max: p rounded to bf16 on both sides (the hardware bf16 exp2 can sit
# one ulp from the rounded fp32 one), another summation order
PROBE_TOL = 1e-2

REPLACES = {
    "flash_fwd": "superresolutionhep_tpu/ops/flash_attention.py:213",
    "flash_fwd_nomax": "superresolutionhep_tpu/ops/flash_attention.py:291",
    "flash_bwd_dq": "superresolutionhep_tpu/ops/flash_attention.py:442",
    "flash_bwd_dkv": "superresolutionhep_tpu/ops/flash_attention.py:464",
    "fused_qkv": "superresolutionhep_tpu/ops/fused_qkv.py:116",
    "fused_mlp": "superresolutionhep_tpu/ops/fused_mlp.py:141",
    "packed_fwd": "superresolutionhep_tpu/ops/flash_packed.py:237",
    "packed_fwd_nomax": "superresolutionhep_tpu/ops/flash_packed.py:237",
    # not a pallas_call: the JAX package computes the band outside its kernel
    "packed_band": "superresolutionhep_tpu/ops/flash_packed.py:79",
    "packed_bwd_dq": "superresolutionhep_tpu/ops/flash_packed.py:381",
    "packed_bwd_dkv": "superresolutionhep_tpu/ops/flash_packed.py:415",
    "probe_variant": "scripts/kernel_experiments.py:122",
    "probe_exp_dtype": "scripts/probe_exp_dtype.py:70",
}
SOURCE = {
    "flash_fwd": "superresolutionhep_tpu_torch/csrc/flash_attention.cu",
    "flash_fwd_nomax": "superresolutionhep_tpu_torch/csrc/flash_attention.cu",
    "flash_bwd_dq": "superresolutionhep_tpu_torch/csrc/flash_attention_bwd.cu",
    "flash_bwd_dkv": "superresolutionhep_tpu_torch/csrc/flash_attention_bwd.cu",
    "fused_qkv": "superresolutionhep_tpu_torch/csrc/fused_qkv.cu",
    "fused_mlp": "superresolutionhep_tpu_torch/csrc/fused_mlp.cu",
    "packed_fwd": "superresolutionhep_tpu_torch/csrc/flash_attention.cu",
    "packed_fwd_nomax": "superresolutionhep_tpu_torch/csrc/flash_attention.cu",
    "packed_band": "superresolutionhep_tpu_torch/csrc/flash_attention.cu",
    "packed_bwd_dq": "superresolutionhep_tpu_torch/csrc/flash_attention_bwd.cu",
    "packed_bwd_dkv": "superresolutionhep_tpu_torch/csrc/flash_attention_bwd.cu",
    "probe_variant": "superresolutionhep_tpu_torch/csrc/attention_probes.cu",
    "probe_exp_dtype": "superresolutionhep_tpu_torch/csrc/attention_probes.cu",
}


SERVE_KERNELS = ("flash_fwd", "flash_fwd_nomax", "fused_qkv", "fused_mlp")
TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
PACKED_S, PACKED_ROWS = 5120, 8  # the JAX package's packing defaults


def emit(obj):
    print(json.dumps(obj), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def time_ms(fn, reps, inner=8):
    """Device time of one call of ``fn`` in ms: ``inner`` calls captured into a
    CUDA graph, replayed ``reps`` times between CUDA events, the median over
    ``inner`` (the package's ``scripts/common.py::graph_ms``).  Replaying a
    graph takes the host out of the interval: timed eagerly, a 20 us kernel
    behind a 100 us Python wrapper reads as 100 us."""
    from superresolutionhep_tpu_torch.scripts.common import graph_ms

    return graph_ms(fn, reps, chain=inner)


def sfu_per_s():
    """fp32 exponentials a second on the card: 16 a clock per SM (the
    special-function units) at the maximum SM clock."""
    return 16 * torch.cuda.get_device_properties(0).multi_processor_count * max_sm_clock_hz()


def fwd_bounds(flops, nbytes, exps, peak):
    """The forward kernels' bound: the larger of the operations over the
    tensor-core peak, the bytes over the memory rate, and one fp32 exp2 per
    needed (query, key) pair over the special-function units' rate."""
    t = {"operations": flops / peak, "bytes": nbytes / H100_BYTES_PER_S}
    sfu = exps / sfu_per_s()
    return {"bound_ms": max(t["operations"], t["bytes"], sfu) * 1e3,
            "bound_by": "operations" if max(t["operations"], sfu) >= t["bytes"] else "bytes",
            "operations_ms": t["operations"] * 1e3, "bytes_ms": t["bytes"] * 1e3, "sfu_bound_ms": sfu * 1e3}


def fp32_attention_bounds(flops, nbytes, exps):
    """The fp32 attention kernels' bound (K1/K2/K7 and K5/K6/K8/K9 on fp32
    operands): the largest of the products as three-term TF32 splits on the
    tensor cores (3 * flops / 495 TFLOP/s), the bytes over the memory rate,
    and one fp32 exp2 per needed (query, key) pair on the special-function
    units (the backward recomputes one a pair).  ``bound_term`` names the
    term that sets it; ``fma_bound_ms`` is the CUDA-core yardstick of earlier
    rows (the flops at 67 TFLOP/s, or the bytes)."""
    t = {"tf32x3": TF32_SPLIT_TERMS * flops / H100_TF32_FLOPS, "bytes": nbytes / H100_BYTES_PER_S,
         "sfu": exps / sfu_per_s()}
    term = max(t, key=t.get)
    return {"bound_ms": t[term] * 1e3, "bound_by": "bytes" if term == "bytes" else "operations",
            "bound_term": term, "operations_ms": t["tf32x3"] * 1e3, "bytes_ms": t["bytes"] * 1e3,
            "sfu_bound_ms": t["sfu"] * 1e3,
            "fma_bound_ms": max(flops / H100_FLOPS[torch.float32], t["bytes"]) * 1e3}


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


def fused_bounds(flops, nbytes, peak):
    t_ops, t_bytes = flops / peak, nbytes / H100_BYTES_PER_S
    return {"bound_ms": max(t_ops, t_bytes) * 1e3, "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def fused_cases(dtype, B, L, F, Fh, form, reps, randn, timed=True):
    """K3 and K4 against their plain versions on the same CUDA tensors, with
    the modulation rows per batch row, per cell, or per segment (a
    ``packed_layout`` row set repeated for the ten ensemble members, tables
    (B, E + 1, F) whose last row is the padding cells').  The bound counts what
    the form reads: the per-segment tables and ids, not per-cell rows.  Also
    a yardstick: ``torch.matmul`` of the same products alone (no single
    PyTorch call computes K3 or K4, so ``library_ms`` is None)."""
    from superresolutionhep_tpu_torch.ops import fused_mlp as fm
    from superresolutionhep_tpu_torch.ops import fused_qkv as fq
    from superresolutionhep_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    dname = "bf16" if dtype == torch.bfloat16 else "fp32"
    isz, peak, tol = (2 if dtype == torch.bfloat16 else 4), H100_FLOPS[dtype], TOL[("fused", dtype)]
    M, seg, O = B * L, None, 3 * F
    if form == "segment":
        _, seg_np, _ = packed_layout()
        seg = torch.from_numpy(np.tile(seg_np, (B // seg_np.shape[0], 1))).to(dev)
        E1 = L // 128 + 1  # the packer's segments (S / SEG_ALIGN) and the zero row
        shape = (B, E1, F)
    else:
        shape = {"batch": (B, F), "cell": (B, L, F)}[form]
    n_rows = int(np.prod(shape))
    seg_bytes = M * 4 if seg is not None else 0
    cases = []

    def case(kernel, out, ref, flops, nbytes, call, plain, mm, **shape_kw):
        err = (out.float() - ref.float()).abs().max().item()
        c = {"kernel": kernel, "dtype": dname, "B": B, "L": L, **shape_kw, "rows": form, "max_abs_err": err,
             "tol": tol, "library_ms": None, **fused_bounds(flops, nbytes, peak),
             "ok": bool(torch.isfinite(out.float()).all()) and err <= tol}
        if timed:
            c["ms"] = time_ms(call, reps)
            c["plain_ms"] = time_ms(plain, max(3, reps // 5))
            c["matmul_yardstick_ms"] = time_ms(mm, reps)
        emit({"phase": "kernel_case", **c})
        cases.append(c)

    # ---- K3: LN + modulate + QKV projection
    x = randn(B, L, F, dtype=dtype)
    w_t = randn(O, F, scale=0.03, dtype=dtype)  # (O, F) as a Linear weight; w = its transposed view
    bias = randn(O, scale=0.1)
    ea, eb = 1.0 + randn(*shape, scale=0.1), randn(*shape, scale=0.1)
    before = kernels.LAUNCHES["fused_qkv"]
    out = fq.fused_ln_mod_proj(x, ea, eb, w_t.t(), bias, segment_ids=seg)
    torch.cuda.synchronize()
    if kernels.LAUNCHES["fused_qkv"] != before + 1:
        fail("fused_qkv: the wrapper did not count its launch")
    ref = fq._ref_ln_mod_proj_rows(x, ea, eb, w_t.t(), bias, seg)
    x2, w2 = x.reshape(M, F), w_t.t()
    case("fused_qkv", out, ref, 2.0 * M * F * O, (M * F + M * O + O * F) * isz + (2 * n_rows + O) * 4 + seg_bytes,
         lambda: fq.fused_ln_mod_proj(x, ea, eb, w_t.t(), bias, segment_ids=seg),
         lambda: fq._ref_ln_mod_proj_rows(x, ea, eb, w_t.t(), bias, seg), lambda: torch.matmul(x2, w2), F=F, O=O)
    del x, out, ref, x2

    # ---- K4: the MLP half-layer
    q = randn(B, L, F, scale=0.5, dtype=dtype)
    att = randn(B, L, F, scale=0.5, dtype=dtype)
    w0_t = randn(Fh, F, scale=0.06, dtype=dtype)
    w1_t = randn(F, Fh, scale=0.06, dtype=dtype)
    b0, b1 = randn(Fh, scale=0.1), randn(F, scale=0.1)
    ga, gm = randn(*shape, scale=0.5), randn(*shape, scale=0.5)
    args = (q, att, ga, ea, eb, gm, w0_t.t(), b0, w1_t.t(), b1)
    before = kernels.LAUNCHES["fused_mlp"]
    out = fm.fused_dit_mlp(*args, segment_ids=seg)
    torch.cuda.synchronize()
    if kernels.LAUNCHES["fused_mlp"] != before + 1:
        fail("fused_mlp: the wrapper did not count its launch")
    ref = fm._ref_dit_mlp_rows(*args, seg)
    q2, hid = q.reshape(M, F), torch.empty(M, Fh, dtype=dtype, device=dev)
    case("fused_mlp", out, ref, 4.0 * M * F * Fh,
         (3 * M * F + 2 * F * Fh) * isz + (4 * n_rows + F + Fh) * 4 + seg_bytes,
         lambda: fm.fused_dit_mlp(*args, segment_ids=seg), lambda: fm._ref_dit_mlp_rows(*args, seg),
         lambda: torch.matmul(torch.matmul(q2, w0_t.t(), out=hid), w1_t.t()), F=F, Fh=Fh)
    return cases


def kernel_cases(reps):
    from superresolutionhep_tpu_torch.ops import flash_attention as fa
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
                if dtype == torch.bfloat16:
                    case.update(fwd_bounds(flops, nbytes, H * sum(n * n for n in lens), peak))
                else:
                    case.update(fp32_attention_bounds(flops, nbytes, H * sum(n * n for n in lens)))
                case["ok"] = ok
                cases.append(case)
                emit({"phase": "kernel_case", **case})

            # ---- K3 / K4: per-batch rows; per-cell rows at L=512
            for form in (("batch", "cell") if L == 512 else ("batch",)):
                cases += fused_cases(dtype, B, L, F, Fh, form, reps, randn)

        # ---- K3 / K4 on the packed batch of the ensemble sampler, rows (80, 5120): per-segment rows
        cases += fused_cases(dtype, 10 * PACKED_ROWS, PACKED_S, F, Fh, "segment", reps, randn,
                             timed=dtype == torch.bfloat16)

    # the PF stage's head dim (16), bf16 and fp32 (PF's default precision):
    # a small case and the PF encoder's shape class, (32, 640) with 4 heads
    for dtype, B16, L16 in ((torch.bfloat16, 4, 256), (torch.float32, 4, 256), (torch.float32, 32, 640)):
        dname = "bf16" if dtype == torch.bfloat16 else "fp32"
        valid, lens = ragged_valid(B16, L16, dev)
        t16 = randn(B16, L16, 3, 4, 16, scale=0.7).to(dtype)
        q16, k16, v16 = t16[:, :, 0], t16[:, :, 1], t16[:, :, 2]  # (B, L, H, 16) strided views
        before = kernels.LAUNCHES["flash_fwd"]
        out16 = fa.masked_flash_attention(q16, k16, v16, valid, valid, scale=0.25)
        torch.cuda.synchronize()
        ref16, _ = fa._ref_attention(*(t.permute(0, 2, 1, 3) for t in (q16, k16, v16)),
                                     valid.float()[:, None], valid.float()[:, None], 0.25)
        err16 = (out16.float() - ref16.permute(0, 2, 1, 3).float()).abs().max().item()
        tol = TOL[("flash", dtype)]
        case = {"kernel": "flash_fwd", "dtype": dname, "B": B16, "H": 4, "L": L16, "D": 16,
                "max_abs_err": err16, "tol": tol,
                "ok": (err16 <= tol and kernels.LAUNCHES["flash_fwd"] == before + 1
                       and bool(torch.isfinite(out16).all()))}
        if L16 == 640:
            flops = 4.0 * 4 * 16 * sum(n * n for n in lens)
            nbytes = 4 * B16 * L16 * 4 * 16 * 4 + 2 * B16 * L16 * 4
            # the kernel alone, on the pre-scaled q (the wrapper's scale
            # constant is a host-to-device copy, which a CUDA graph cannot hold)
            q16_pre, qm16 = q16 * (0.25 * fa.LOG2E), valid.float().contiguous()
            qh, kh, vh = (t.permute(0, 2, 1, 3).contiguous() for t in (q16, k16, v16))
            case.update({
                "ms": time_ms(lambda: fa._flash_fwd_cuda(q16_pre, k16, v16, qm16, qm16, nomax=False,
                                                         with_lse=False), reps),
                "plain_ms": time_ms(lambda: fa._ref_attention(qh, kh, vh, qm16[:, None], qm16[:, None], 0.25),
                                    max(3, reps // 5)),
                "library_ms": time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
                    qh, kh, vh, attn_mask=valid[:, None, None, :], scale=0.25), reps),
                **fp32_attention_bounds(flops, nbytes, 4 * sum(n * n for n in lens))})
        cases.append(case)
        emit({"phase": "kernel_case", **case})

    bad = [c for c in cases if not c["ok"]]
    if bad:
        fail(f"{len(bad)} kernel case(s) disagree with the plain version: "
             + "; ".join(f"{c['kernel']}/{c['dtype']}/L={c['L']} err={c['max_abs_err']:.3g} tol={c['tol']}" for c in bad))
    return cases


def band_rows():
    """(3, 1024) segment ids whose bands at both tile heights have one key
    tile (a 51-cell segment alone in the first 192 cells), several (a
    segment of 809 cells), none (query tiles of padding, a row of padding),
    and boundaries inside tiles (three segments at 0, 300, 584); 1024 is no
    multiple of 192, so the last query tile is ragged."""
    seg = np.full((3, 1024), -1, np.int32)
    seg[0, :51], seg[0, 192:1001] = 0, 1
    seg[1, :300], seg[1, 300:584], seg[1, 584:1000] = 0, 1, 2
    return seg


def fwd_tile_cases(reps):
    """The bf16 forward body (K1, K2, K7) at head dims 16, 32 and 64 and at
    both tile heights the wrapper can pick (64 and 192 rows), against the
    plain versions on the same CUDA tensors: K1 with Lq != Lk and ragged
    masks, K2 also against the robust plain version, K7 robust and no-max on
    ``band_rows``; the band kernel against its plain version (``band_ranges``)
    at both heights on ``band_rows`` and on the (8, 5120) packed layout,
    where it is timed (the kernels line's ``packed_band`` entry)."""
    from superresolutionhep_tpu_torch.ops import flash_attention as fa
    from superresolutionhep_tpu_torch.ops import flash_packed as fp
    from superresolutionhep_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4321)
    H = 4
    tol, lse_tol = TOL[("flash", torch.bfloat16)], TOL[("lse", torch.bfloat16)]
    x_tol = TOL[("nomax_vs_robust", torch.bfloat16)]
    cases = []

    def launched_once(name, before):
        if kernels.LAUNCHES[name] != before + 1:
            fail(f"{name}: the wrapper did not count its launch")

    def rel(a, b):
        return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-12)).item()

    # ---- K1 / K2: Lq != Lk, ragged masks, (B, L, H, D) strided views of fused buffers
    B, Lq, Lk = 3, 640, 896
    qvalid, _ = ragged_valid(B, Lq, dev)
    kvalid = torch.arange(Lk, device=dev)[None, :] < torch.tensor([Lk, 517, 70], device=dev)[:, None]
    qm, km = qvalid.float().contiguous(), kvalid.float().contiguous()
    for D in (16, 32, 64):
        qb = (torch.randn(B, Lq, 2, H, D, generator=g, device=dev) * (2.0 / D ** 0.25)).to(torch.bfloat16)
        kv = torch.randn(B, Lk, 3, H, D, generator=g, device=dev).to(torch.bfloat16)
        q, k, v = qb[:, :, 1], kv[:, :, 0], kv[:, :, 2]
        qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
        robust_ref, robust_lse = fa._ref_attention_base2(qh, kh, vh, qm[:, None], km[:, None], "max", with_lse=True)
        nomax_ref = fa._ref_attention_base2(qh, kh, vh, qm[:, None], km[:, None], "nomax_clip")
        for bq in (64, 192):
            for name, nomax in (("flash_fwd", False), ("flash_fwd_nomax", True)):
                before = kernels.LAUNCHES[name]
                out, lse = fa._flash_fwd_cuda(q, k, v, qm, km, nomax=nomax, with_lse=not nomax, block_q=bq)
                torch.cuda.synchronize()
                launched_once(name, before)
                out = out.permute(0, 2, 1, 3).float()
                ref = nomax_ref if nomax else robust_ref
                err = (out - ref.float()).abs().max().item()
                case = {"kernel": name, "dtype": "bf16", "case": "tiles", "B": B, "H": H, "Lq": Lq, "L": Lk, "D": D,
                        "block_q": bq, "max_abs_err": err, "tol": tol}
                ok = bool(torch.isfinite(out).all()) and err <= tol
                ok = ok and float(out.permute(0, 2, 1, 3)[~qvalid].abs().max()) == 0.0
                if nomax:
                    xerr = (out - robust_ref.float()).abs().max().item()
                    case["vs_robust_max_abs_err"], case["vs_robust_tol"] = xerr, x_tol
                    ok = ok and xerr <= x_tol
                else:
                    vq = qvalid[:, None, :].expand(B, H, Lq)
                    lerr = (lse - robust_lse)[vq].abs().max().item()
                    case["lse_max_abs_err"], case["lse_tol"] = lerr, lse_tol
                    ok = ok and lerr <= lse_tol
                case["ok"] = ok
                cases.append(case)
                emit({"phase": "kernel_case", **case})

    # ---- the band table and K7 on rows with bands of one tile, several and none
    seg_host = band_rows()
    seg = torch.from_numpy(seg_host).to(dev)
    Bs, S = seg.shape
    pad = seg < 0
    for bq in (64, 192):
        before = kernels.LAUNCHES["packed_band"]
        band = fp.packed_band(seg, bq)
        torch.cuda.synchronize()
        launched_once("packed_band", before)
        want = fp.packed_band(seg.cpu(), bq)
        lengths = sorted(set(want[..., 1].flatten().tolist()))
        case = {"kernel": "packed_band", "dtype": "int32", "case": "band_rows", "B": Bs, "L": S, "block_q": bq,
                "band_lengths": lengths, "max_abs_err": float((band.cpu() - want).abs().max()),
                "ok": bool(torch.equal(band.cpu(), want)) and {0, 1}.issubset(lengths) and max(lengths) > 1}
        cases.append(case)
        emit({"phase": "kernel_case", **case})
    for D in (16, 32, 64):
        qkv = torch.randn(Bs, S, 3, H, D, generator=g, device=dev)
        qkv[:, :, 0] *= 2.0 / D ** 0.25
        qkv = qkv.to(torch.bfloat16)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
        robust_ref, robust_lse = fp._ref_packed_fwd(qh, kh, vh, seg, "max", with_lse=True)
        nomax_ref = fp._ref_packed_fwd(qh, kh, vh, seg, "nomax_clip")
        robust_ref, nomax_ref = robust_ref.permute(0, 2, 1, 3), nomax_ref.permute(0, 2, 1, 3)
        for bq in (64, 192):
            for name, nomax in (("packed_fwd", False), ("packed_fwd_nomax", True)):
                before = kernels.LAUNCHES[name]
                out, lse = fp._packed_fwd_cuda(q, k, v, seg, nomax=nomax, with_lse=not nomax, block_q=bq)
                torch.cuda.synchronize()
                launched_once(name, before)
                ref = nomax_ref if nomax else robust_ref
                err = rel(out, ref)
                case = {"kernel": name, "dtype": "bf16", "case": "band_rows", "B": Bs, "H": H, "L": S, "D": D,
                        "block_q": bq, "max_abs_err": (out.float() - ref.float()).abs().max().item(),
                        "max_rel_err": err, "tol_rel": tol,
                        "padding_exactly_zero": float(out.float()[pad].abs().max()) == 0.0}
                ok = bool(torch.isfinite(out.float()).all()) and err <= tol and case["padding_exactly_zero"]
                if nomax:
                    xerr = (out.float() - robust_ref.float()).abs().max().item()
                    case["vs_robust_max_abs_err"], case["vs_robust_tol"] = xerr, x_tol
                    ok = ok and xerr <= x_tol
                else:
                    lerr = (lse - robust_lse)[(~pad)[:, None, :].expand(Bs, H, S)].abs().max().item()
                    case["lse_max_abs_err_valid"], case["lse_tol"] = lerr, lse_tol
                    ok = ok and lerr <= lse_tol
                case["ok"] = ok
                cases.append(case)
                emit({"phase": "kernel_case", **case})

    # ---- the band kernel on the (8, 5120) packed layout, timed
    _, seg_np, _ = packed_layout()
    seg = torch.from_numpy(seg_np).to(dev)
    Bp, Sp = seg.shape
    bq = fa.fwd_tile_rows(Bp, H, Sp, torch.cuda.get_device_properties(0).multi_processor_count)
    band = fp.packed_band(seg, bq)
    torch.cuda.synchronize()
    want = fp.packed_band(seg.cpu(), bq)
    nbytes = Bp * Sp * 4 + band.numel() * 4  # the ids read once, the table written once
    case = {"kernel": "packed_band", "dtype": "int32", "case": "packed", "B": Bp, "L": Sp, "block_q": bq,
            "max_abs_err": float((band.cpu() - want).abs().max()), "ok": bool(torch.equal(band.cpu(), want)),
            "ms": time_ms(lambda: fp.packed_band(seg, bq), reps),
            "plain_ms": time_ms(lambda: fp._ref_packed_band(seg, bq), max(3, reps // 5)),
            "library_ms": None, "bound_ms": nbytes / H100_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    cases.append(case)
    emit({"phase": "kernel_case", **case})

    bad = [c for c in cases if not c["ok"]]
    if bad:
        fail(f"{len(bad)} forward tile case(s) disagree with the plain version: "
             + "; ".join(f"{c['kernel']}/D={c.get('D')}/rows={c.get('block_q')}/{c['case']}" for c in bad))
    return cases


def ptxas_report():
    """Registers and spills of every instantiation of the bf16 forward and
    backward kernels, of the probes (the forward body at their modes and
    tiles), of the bf16 fused kernels and of the fp32 attention kernels (the
    forward, dq and dk/dv on the tensor cores), and the functions whose
    wgmma ptxas serialised (warnings C751x), from nvcc's -Xptxas -v log.
    ``ok``: every kind has instantiations, none spills, no wgmma kernel is
    serialised."""
    import re

    from superresolutionhep_tpu_torch.ops import kernels

    patterns = {
        "flash_fwd_wgmma_kernel": (r"flash_fwd_wgmma_kernelILi(\d+)ELb([01])ELb([01])ELi(\d)E",
                                   lambda m: {"D": int(m[0]), "nomax": m[1] == "1", "seg": m[2] == "1",
                                              "block_q": 64 * int(m[3])}),
        "fused_qkv_wgmma_kernel": (r"fused_qkv_wgmma_kernelILi(\d+)E", lambda m: {"F": int(m[0])}),
        "fused_mlp_wgmma_kernel": (r"fused_mlp_wgmma_kernelILi(\d+)ELi(\d+)E",
                                   lambda m: {"F": int(m[0]), "Fh": int(m[1])}),
        "flash_bwd_dq_wgmma_kernel": (r"flash_bwd_dq_wgmma_kernelILi(\d+)ELb([01])ELi(\d)E",
                                      lambda m: {"D": int(m[0]), "seg": m[1] == "1", "block_rows": 64 * int(m[2])}),
        "flash_bwd_dkv_wgmma_kernel": (r"flash_bwd_dkv_wgmma_kernelILi(\d+)ELb([01])ELi(\d)E",
                                       lambda m: {"D": int(m[0]), "seg": m[1] == "1", "block_rows": 64 * int(m[2])}),
        "probe_fwd_wgmma_kernel": (r"probe_fwd_wgmma_kernelILi(\d)ELb([01])ELi(\d)ELi(\d+)E",
                                   lambda m: {"mode": int(m[0]), "mask": m[1] == "1", "block_q": 64 * int(m[2]),
                                              "block_k": int(m[3])}),
        "flash_fwd_f32_kernel": (r"flash_fwd_f32_kernelILi(\d+)ELb([01])ELb([01])E",
                                 lambda m: {"D": int(m[0]), "nomax": m[1] == "1", "seg": m[2] == "1"}),
        "flash_bwd_dq_f32_kernel": (r"flash_bwd_dq_f32_kernelILi(\d+)ELb([01])E",
                                    lambda m: {"D": int(m[0]), "seg": m[1] == "1"}),
        "flash_bwd_dkv_f32_kernel": (r"flash_bwd_dkv_f32_kernelILi(\d+)ELb([01])E",
                                     lambda m: {"D": int(m[0]), "seg": m[1] == "1"}),
    }
    rows = {k: [] for k in patterns}
    serialised = []
    name, spill = None, (None, None)
    for line in (kernels.build_dir() / "nvcc_log.txt").read_text().splitlines():
        ser = re.search(r"\((C751\d)\).*function '(\S+?)'", line)
        if ser:
            serialised.append({"code": ser.group(1), "function": ser.group(2)})
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        for kind, (pat, fields) in patterns.items():
            inst = re.search(pat, name or "")
            if inst is None:
                continue
            sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if sp:
                spill = (int(sp.group(1)), int(sp.group(2)))
            reg = re.search(r"Used (\d+) registers", line)
            if reg:
                rows[kind].append({**fields(inst.groups()), "registers_at_launch": int(reg.group(1)),
                                   "spill_stores": spill[0], "spill_loads": spill[1],
                                   "serialised": [s["code"] for s in serialised if s["function"] == name]})
                name = None
    ok = (all(rows.values()) and all(r["spill_stores"] == 0 and r["spill_loads"] == 0 and not r["serialised"]
                                     for rs in rows.values() for r in rs)
          and not any(re.search(r"wgmma_kernel", s["function"]) for s in serialised))
    return {**rows, "serialised_wgmma": serialised, "ok": ok}


def bwd_kernel_cases(reps):
    """K5 (dq) and K6 (dk, dv) against ``_ref_flash_bwd_{dq,dkv}`` on the same
    CUDA tensors, from the forward kernel's own LSE; then autograd through
    ``masked_flash_attention`` (K1 + K5 + K6) against autograd through the
    dense plain formulation."""
    from superresolutionhep_tpu_torch.ops import flash_attention as fa
    from superresolutionhep_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4321)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    def rel_err(a, b):
        return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-12)).item()

    cases = []
    shapes = [(10, 4, 64, L) for L in (512, 2048, 3584)] + [(4, 4, 16, 256)]
    for dtype in (torch.bfloat16, torch.float32):
        dname = "bf16" if dtype == torch.bfloat16 else "fp32"
        isz = 2 if dtype == torch.bfloat16 else 4
        peak = H100_FLOPS[dtype]
        # the PF encoder's shape class (head dim 16, fp32 training)
        for B, H, D, L in shapes + ([(32, 4, 16, 640)] if dtype == torch.float32 else []):
            valid, lens = ragged_valid(B, L, dev)
            qm = valid.float().contiguous()
            # q/k/v as strided views of one (B, L, 3, H, D) projection, q pre-scaled
            qkv = randn(B, L, 3, H, D)
            qkv[:, :, 0] *= (1.0 / D**0.5) * fa.LOG2E * 2.0
            qkv = qkv.to(dtype)
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            out, lse = fa._flash_fwd_cuda(q, k, v, qm, qm, nomax=False, with_lse=True)
            gr = randn(B, L, H, D).to(dtype) * (qm[:, :, None, None] > 0).to(dtype)
            dl = (out.float() * gr.float()).sum(-1).transpose(1, 2).contiguous()
            args = (q, k, v, gr, lse, dl, qm, qm)
            qh, kh, vh, gh = fa._heads_first(q, k, v, gr)
            ref_args = (qh, kh, vh, gh, lse, dl, qm[:, None])
            before = dict(kernels.LAUNCHES)
            dq = fa._flash_bwd_dq_cuda(*args)
            dk, dv = fa._flash_bwd_dkv_cuda(*args)
            torch.cuda.synchronize()
            if (kernels.LAUNCHES["flash_bwd_dq"] != before["flash_bwd_dq"] + 1
                    or kernels.LAUNCHES["flash_bwd_dkv"] != before["flash_bwd_dkv"] + 1):
                fail("flash backward: a wrapper did not count its launch")
            ref_dq = fa._ref_flash_bwd_dq(*ref_args).permute(0, 2, 1, 3)
            ref_dk, ref_dv = (t.permute(0, 2, 1, 3) for t in fa._ref_flash_bwd_dkv(*ref_args))
            tol = TOL[("flash_bwd", dtype)]
            pairs = sum(n * n for n in lens)
            nbytes_in = 4 * B * L * H * D * isz + 2 * B * H * L * 4 + 2 * B * L * 4
            # yardstick only (the port never calls it): SDPA's memory-efficient
            # backward for the same boolean key mask, read as (fwd+bwd) - fwd,
            # at D = 64 and at PF's fp32 shape class (32, 640), D = 16
            library_ms = library_fwd_bwd_ms = None
            if D == 64 or (B, L) == (32, 640):
                from torch.nn.attention import SDPBackend, sdpa_kernel

                qc, kc, vc = (t.permute(0, 2, 1, 3).contiguous().requires_grad_(True) for t in (q, k, v))
                gc = gr.permute(0, 2, 1, 3).contiguous()
                amask = valid[:, None, None, :]
                with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                    def lib_fwd():
                        return torch.nn.functional.scaled_dot_product_attention(qc, kc, vc, attn_mask=amask,
                                                                                scale=fa.LN2)

                    def lib_fwd_bwd():
                        return torch.autograd.grad(lib_fwd(), (qc, kc, vc), gc)

                    library_fwd_bwd_ms = time_ms(lib_fwd_bwd, reps)
                    library_ms = library_fwd_bwd_ms - time_ms(lambda: lib_fwd().detach(), reps)
            for name, got, ref, flops, nbytes in (
                ("flash_bwd_dq", (dq,), (ref_dq,), 6.0 * H * D * pairs, nbytes_in + B * L * H * D * isz),
                ("flash_bwd_dkv", (dk, dv), (ref_dk, ref_dv), 8.0 * H * D * pairs, nbytes_in + 2 * B * L * H * D * isz),
            ):
                errs = [rel_err(a, b) for a, b in zip(got, ref)]
                rows_ok = all(float(t.float()[~valid].abs().max()) == 0.0 for t in got) if (~valid).any() else True
                fn = fa._flash_bwd_dq_cuda if name == "flash_bwd_dq" else fa._flash_bwd_dkv_cuda
                plain = fa._ref_flash_bwd_dq if name == "flash_bwd_dq" else fa._ref_flash_bwd_dkv
                case = {"kernel": name, "dtype": dname, "B": B, "H": H, "L": L, "D": D,
                        "max_abs_err": max((a.float() - b.float()).abs().max().item() for a, b in zip(got, ref)),
                        "max_rel_err": max(errs), "tol_rel": tol, "padded_rows_exactly_zero": rows_ok,
                        "ms": time_ms(lambda: fn(*args), reps),
                        "plain_ms": time_ms(lambda: plain(*ref_args), max(3, reps // 5)),
                        "library_ms": library_ms, "library_covers": "dq+dk+dv",
                        "library_fwd_bwd_ms": library_fwd_bwd_ms}
                if dtype == torch.bfloat16:  # one exp2 per live pair, as the forward's bound counts them
                    case["bound_ms"] = max(flops / peak, nbytes / H100_BYTES_PER_S) * 1e3
                    case["bound_by"] = "operations" if flops / peak >= nbytes / H100_BYTES_PER_S else "bytes"
                    case["sfu_bound_ms"] = H * pairs / sfu_per_s() * 1e3
                else:
                    case.update(fp32_attention_bounds(flops, nbytes, H * pairs))
                case["ok"] = bool(all(torch.isfinite(t.float()).all() for t in got)) and max(errs) <= tol and rows_ok
                cases.append(case)
                emit({"phase": "kernel_case", **case})

    # autograd: masked_flash_attention (K1 forward with LSE, K5, K6) against the
    # dense natural-base plain formulation, on the same CUDA tensors
    B, L, H, D = 4, 512, 4, 64
    valid, _ = ragged_valid(B, L, dev)
    x = [randn(B, L, H, D).requires_grad_(True) for _ in range(3)]
    w = randn(B, L, H, D)
    before = dict(kernels.LAUNCHES)
    out = fa.masked_flash_attention(*x, valid, valid, scale=D**-0.5)
    got = torch.autograd.grad((out * w).sum(), x)
    torch.cuda.synchronize()
    launched = {k: kernels.LAUNCHES[k] - before[k] for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    ref_out, _ = fa._ref_attention(*(t.permute(0, 2, 1, 3) for t in x), valid.float()[:, None],
                                   valid.float()[:, None], D**-0.5)
    want = torch.autograd.grad((ref_out.permute(0, 2, 1, 3) * w).sum(), x)
    errs = [rel_err(a, b) for a, b in zip(got, want)]
    tol = TOL[("flash_grad", torch.float32)]
    case = {"kernel": "flash_autograd", "dtype": "fp32", "B": B, "H": H, "L": L, "D": D,
            "max_rel_err_dq_dk_dv": errs, "tol_rel": tol, "launches": launched,
            "ok": max(errs) <= tol and all(n == 1 for n in launched.values())}
    cases.append(case)
    emit({"phase": "kernel_case", **case})

    bad = [c for c in cases if not c["ok"]]
    if bad:
        fail(f"{len(bad)} backward case(s) disagree with the plain version: "
             + "; ".join(f"{c['kernel']}/{c['dtype']}/L={c['L']}" for c in bad))
    return cases


def bwd_tile_cases():
    """The bf16 backward bodies (K5/K6 masked, K8/K9 packed) at head dims 16,
    32 and 64 and at both tile heights the wrappers can pick (64 and 128
    rows), against the plain versions on the same CUDA tensors, from the
    forward kernel's own LSE: masked with Lq != Lk, neither a multiple of 64
    (Lq no multiple of 4 either, so lse and dl reach the kernel padded), ragged
    query and key masks; packed on ``band_rows`` (bands of one key tile,
    several and none, segment boundaries inside tiles, fully padded tiles).
    Every output is held at each output's max to the backward's bound,
    padding exactly 0, and a second launch on the same inputs must equal the
    first bit for bit (no atomics)."""
    from superresolutionhep_tpu_torch.ops import flash_attention as fa
    from superresolutionhep_tpu_torch.ops import flash_packed as fp
    from superresolutionhep_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2468)
    H = 4
    tol = TOL[("flash_bwd", torch.bfloat16)]
    cases = []

    def rel(a, b):
        return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-12)).item()

    def check(kernel, case, fn, refs, zero_rows):
        before = kernels.LAUNCHES[kernel]
        got = fn()
        again = fn()
        torch.cuda.synchronize()
        if kernels.LAUNCHES[kernel] != before + 2:
            fail(f"{kernel}: the wrapper did not count its launches")
        got, again = (x if isinstance(x, tuple) else (x,) for x in (got, again))
        errs = [rel(a, b) for a, b in zip(got, refs)]
        case.update({"kernel": kernel, "dtype": "bf16", "max_rel_err": max(errs), "tol_rel": tol,
                     "max_abs_err": max((a.float() - b.float()).abs().max().item() for a, b in zip(got, refs)),
                     "deterministic": all(torch.equal(a, b) for a, b in zip(got, again)),
                     "padding_exactly_zero": all(float(t.float()[zero_rows].abs().max()) == 0.0 for t in got)})
        case["ok"] = (bool(all(torch.isfinite(t.float()).all() for t in got)) and max(errs) <= tol
                      and case["deterministic"] and case["padding_exactly_zero"])
        cases.append(case)
        emit({"phase": "kernel_case", **case})

    # ---- K5 / K6: Lq != Lk, neither a multiple of 64, ragged masks, strided views of fused buffers
    B, Lq, Lk = 3, 602, 1000
    qvalid, _ = ragged_valid(B, Lq, dev)
    kvalid = torch.arange(Lk, device=dev)[None, :] < torch.tensor([Lk, 517, 70], device=dev)[:, None]
    qm, km = qvalid.float().contiguous(), kvalid.float().contiguous()
    for D in (16, 32, 64):
        qb = (torch.randn(B, Lq, 2, H, D, generator=g, device=dev) * (2.0 / D ** 0.25)).to(torch.bfloat16)
        kv = torch.randn(B, Lk, 3, H, D, generator=g, device=dev).to(torch.bfloat16)
        q, k, v = qb[:, :, 1], kv[:, :, 0], kv[:, :, 2]
        out, lse = fa._flash_fwd_cuda(q, k, v, qm, km, nomax=False, with_lse=True)
        gr = torch.randn(B, Lq, H, D, generator=g, device=dev).to(torch.bfloat16) * qvalid[:, :, None, None]
        dl = (out.float() * gr.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, gr, lse, dl, qm, km)
        ref_args = (*fa._heads_first(q, k, v, gr), lse, dl, km[:, None])
        ref_dq = fa._ref_flash_bwd_dq(*ref_args).permute(0, 2, 1, 3)
        ref_dk, ref_dv = (t.permute(0, 2, 1, 3) for t in fa._ref_flash_bwd_dkv(*ref_args))
        for rows in (64, 128):
            shape = {"case": "tiles", "B": B, "H": H, "Lq": Lq, "L": Lk, "D": D, "block_rows": rows}
            check("flash_bwd_dq", dict(shape), lambda: fa._flash_bwd_dq_cuda(*args, block_rows=rows), (ref_dq,),
                  ~qvalid)
            check("flash_bwd_dkv", dict(shape), lambda: fa._flash_bwd_dkv_cuda(*args, block_rows=rows),
                  (ref_dk, ref_dv), ~kvalid)

    # ---- K8 / K9 on rows with bands of one tile, several and none
    seg = torch.from_numpy(band_rows()).to(dev)
    Bs, S = seg.shape
    pad = seg < 0
    for D in (16, 32, 64):
        qkv = torch.randn(Bs, S, 3, H, D, generator=g, device=dev)
        qkv[:, :, 0] *= 2.0 / D ** 0.25
        qkv = qkv.to(torch.bfloat16)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        out, lse = fp._packed_fwd_cuda(q, k, v, seg, nomax=False, with_lse=True)
        gr = torch.randn(Bs, S, H, D, generator=g, device=dev).to(torch.bfloat16) * (~pad)[:, :, None, None]
        dl = (out.float() * gr.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, gr, lse, dl, seg)
        ref_args = (*fa._heads_first(q, k, v, gr), lse, dl, seg)
        ref_dq = fp._ref_packed_bwd_dq(*ref_args).permute(0, 2, 1, 3)
        ref_dk, ref_dv = (t.permute(0, 2, 1, 3) for t in fp._ref_packed_bwd_dkv(*ref_args))
        for rows in (64, 128):
            shape = {"case": "band_rows", "B": Bs, "H": H, "L": S, "D": D, "block_rows": rows}
            check("packed_bwd_dq", dict(shape), lambda: fp._packed_bwd_dq_cuda(*args, block_rows=rows), (ref_dq,), pad)
            check("packed_bwd_dkv", dict(shape), lambda: fp._packed_bwd_dkv_cuda(*args, block_rows=rows),
                  (ref_dk, ref_dv), pad)

    bad = [c for c in cases if not c["ok"]]
    if bad:
        fail(f"{len(bad)} backward tile case(s) disagree with the plain version or are not deterministic: "
             + "; ".join(f"{c['kernel']}/D={c['D']}/rows={c['block_rows']}/{c['case']}" for c in bad))
    return cases


def fp32_tile_cases():
    """The fp32 attention kernels on the tensor cores (K1/K2, K5 and K6, K7,
    K8 and K9 fp32) at head dims 16, 32 and 64 against
    the plain versions on the same CUDA tensors, from the forward kernel's
    own LSE: masked with Lq != Lk (the backward's neither a multiple of 64,
    keys ending inside tiles, fully padded key tiles), packed on
    ``band_rows``; then the guard: base-2 logits of std ~8 (q and k of std
    (8 / sqrt(D))^(1/2)), at which single TF32 products miss these bounds
    (``tests/test_torch_port_fp32_split.py``), forward, dq and dk/dv at D =
    16 and 64; then offset keys at (4, 2048, 4, 16): head-dim column 0 of
    every key 100 times its spread and 0 in every query, so that the logits
    do not see it but dQ's running sums along it reach ~100x dQ (the tensor
    cores round an mma's sum toward zero: dQ summed as one chain misses the
    bound there, each 8-key step summed apart meets it, PERF.md §6).  Forward
    outputs are held absolutely to TOL["flash"] (the LSE to TOL["lse"]),
    backward outputs to TOL["flash_bwd"] of each output's max; padding exactly
    0; dq and dk/dv launched twice, equal bit for bit."""
    from superresolutionhep_tpu_torch.ops import flash_attention as fa
    from superresolutionhep_tpu_torch.ops import flash_packed as fp
    from superresolutionhep_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1357)
    H, f32 = 4, torch.float32
    tol, lse_tol, bwd_tol = TOL[("flash", f32)], TOL[("lse", f32)], TOL[("flash_bwd", f32)]
    cases = []

    def rel(a, b):
        return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-12)).item()

    def zero_at(t, rows):  # (B, L, H, D) output, (B, L) bool
        return float(t[rows].abs().max()) == 0.0 if rows.any() else True

    def launch(name, fn, n=1):
        before = kernels.LAUNCHES[name]
        res = [fn() for _ in range(n)]
        torch.cuda.synchronize()
        if kernels.LAUNCHES[name] != before + n:
            fail(f"{name}: the wrapper did not count its launch")
        return res

    def fwd(name, shape, out, lse, ref, ref_lse, pad, valid_q):
        case = {"kernel": name, "dtype": "fp32", **shape, "max_abs_err": (out - ref).abs().max().item(), "tol": tol,
                "max_rel_err": rel(out, ref), "padding_exactly_zero": zero_at(out, pad)}
        ok = bool(torch.isfinite(out).all()) and case["max_abs_err"] <= tol and case["padding_exactly_zero"]
        if lse is not None:
            case["lse_max_abs_err"], case["lse_tol"] = (lse - ref_lse)[valid_q].abs().max().item(), lse_tol
            ok = ok and case["lse_max_abs_err"] <= lse_tol
        case["ok"] = ok
        cases.append(case)
        emit({"phase": "kernel_case", **case})

    def bwd(name, shape, got, refs, pad, again=None):
        errs = [rel(a, b) for a, b in zip(got, refs)]
        case = {"kernel": name, "dtype": "fp32", **shape, "max_rel_err": max(errs), "tol_rel": bwd_tol,
                "max_abs_err": max((a - b).abs().max().item() for a, b in zip(got, refs)),
                "padding_exactly_zero": all(zero_at(t, pad) for t in got)}
        ok = bool(all(torch.isfinite(t).all() for t in got)) and max(errs) <= bwd_tol and case["padding_exactly_zero"]
        if again is not None:
            case["deterministic"] = all(torch.equal(a, b) for a, b in zip(got, again))
            ok = ok and case["deterministic"]
        case["ok"] = ok
        cases.append(case)
        emit({"phase": "kernel_case", **case})

    def masked(B, Lq, Lk, D, qlens, klens, logit_std, label, k_offset=0.0):
        qvalid = torch.arange(Lq, device=dev)[None, :] < torch.tensor(qlens, device=dev)[:, None]
        kvalid = torch.arange(Lk, device=dev)[None, :] < torch.tensor(klens, device=dev)[:, None]
        qm, km = qvalid.float().contiguous(), kvalid.float().contiguous()
        sd = (logit_std / D ** 0.5) ** 0.5
        qb = torch.randn(B, Lq, 2, H, D, generator=gen, device=dev) * sd  # q and g share a buffer: strided views
        kv = torch.randn(B, Lk, 3, H, D, generator=gen, device=dev)
        kv[:, :, 0] *= sd
        q, k, v = qb[:, :, 1], kv[:, :, 0], kv[:, :, 2]
        if k_offset:
            q[..., 0] = 0.0
            k[..., 0] += k_offset * sd
        qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
        ref, ref_lse = fa._ref_attention_base2(qh, kh, vh, qm[:, None], km[:, None], "max", with_lse=True)
        shape = {"case": label, "B": B, "H": H, "Lq": Lq, "L": Lk, "D": D}
        (out, lse), = launch("flash_fwd", lambda: fa._flash_fwd_cuda(q, k, v, qm, km, nomax=False, with_lse=True))
        vq = qvalid[:, None, :].expand(B, H, Lq)
        fwd("flash_fwd", shape, out, lse, ref.permute(0, 2, 1, 3), ref_lse, ~qvalid, vq)
        if label == "tiles":
            nomax_ref = fa._ref_attention_base2(qh, kh, vh, qm[:, None], km[:, None], "nomax_clip")
            (out_n, _), = launch("flash_fwd_nomax", lambda: fa._flash_fwd_cuda(q, k, v, qm, km, nomax=True,
                                                                              with_lse=False))
            fwd("flash_fwd_nomax", shape, out_n, None, nomax_ref.permute(0, 2, 1, 3), None, ~qvalid, vq)
        g = (qb[:, :, 0] / sd) * qvalid[:, :, None, None]
        dl = (out * g).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, g, lse, dl, qm, km)
        ref_args = (*fa._heads_first(q, k, v, g), lse, dl, km[:, None])
        ref_dk, ref_dv = (t.permute(0, 2, 1, 3) for t in fa._ref_flash_bwd_dkv(*ref_args))
        got, again = launch("flash_bwd_dkv", lambda: fa._flash_bwd_dkv_cuda(*args), 2)
        bwd("flash_bwd_dkv", shape, got, (ref_dk, ref_dv), ~kvalid, again)
        got, again = launch("flash_bwd_dq", lambda: (fa._flash_bwd_dq_cuda(*args),), 2)
        bwd("flash_bwd_dq", shape, got, (fa._ref_flash_bwd_dq(*ref_args).permute(0, 2, 1, 3),), ~qvalid, again)

    for D in (16, 32, 64):
        masked(3, 602, 1000, D, [602, 589, 300], [1000, 517, 70], 2.9, "tiles")
    for D in (16, 64):
        masked(4, 640, 640, D, [640, 627, 321, 1], [640, 627, 321, 1], 8.0, "guard")
    masked(4, 2048, 2048, 16, [2048] * 4, [2048] * 4, 2.9, "offset_keys", k_offset=100.0)

    # ---- K7, K8, K9 on rows with bands of one tile, several and none
    seg = torch.from_numpy(band_rows()).to(dev)
    Bs, S = seg.shape
    pad = seg < 0
    for D in (16, 32, 64):
        qkv = torch.randn(Bs, S, 3, H, D, generator=gen, device=dev)
        qkv[:, :, 0] *= 2.0 / D ** 0.25
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
        ref, ref_lse = fp._ref_packed_fwd(qh, kh, vh, seg, "max", with_lse=True)
        shape = {"case": "band_rows", "B": Bs, "H": H, "L": S, "D": D}
        (out, lse), = launch("packed_fwd", lambda: fp._packed_fwd_cuda(q, k, v, seg, nomax=False, with_lse=True))
        fwd("packed_fwd", shape, out, lse, ref.permute(0, 2, 1, 3), ref_lse, pad, (~pad)[:, None, :].expand(Bs, H, S))
        (out_n, _), = launch("packed_fwd_nomax", lambda: fp._packed_fwd_cuda(q, k, v, seg, nomax=True, with_lse=False))
        fwd("packed_fwd_nomax", shape, out_n, None, fp._ref_packed_fwd(qh, kh, vh, seg, "nomax_clip").permute(0, 2, 1, 3),
            None, pad, None)
        g = torch.randn(Bs, S, H, D, generator=gen, device=dev) * (~pad)[:, :, None, None]
        dl = (out * g).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, g, lse, dl, seg)
        ref_args = (*fa._heads_first(q, k, v, g), lse, dl, seg)
        ref_dk, ref_dv = (t.permute(0, 2, 1, 3) for t in fp._ref_packed_bwd_dkv(*ref_args))
        got, again = launch("packed_bwd_dkv", lambda: fp._packed_bwd_dkv_cuda(*args), 2)
        bwd("packed_bwd_dkv", shape, got, (ref_dk, ref_dv), pad, again)
        got, again = launch("packed_bwd_dq", lambda: (fp._packed_bwd_dq_cuda(*args),), 2)
        bwd("packed_bwd_dq", shape, got, (fp._ref_packed_bwd_dq(*ref_args).permute(0, 2, 1, 3),), pad, again)

    bad = [c for c in cases if not c["ok"]]
    if bad:
        fail(f"{len(bad)} fp32 tile or guard case(s) disagree with the plain version: "
             + "; ".join(f"{c['kernel']}/D={c['D']}/{c['case']}" for c in bad))
    return cases


def multipart_dataset(cfg_mv, n, seed, make_low=False, make_particles=False, **kw):
    """``n`` synthetic multi-particle events (``GeneratorConfig(res_factor=4,
    **kw)``) as an in-memory ``SupResEvents``."""
    from superresolutionhep_tpu_torch.data.sr_dataset import SupResEvents
    from superresolutionhep_tpu_torch.data.synthetic import GeneratorConfig, generate_events

    trees = generate_events(n, seed=seed, config=GeneratorConfig(res_factor=4, **kw))
    return SupResEvents.from_trees(trees["Low_Tree"], trees["High_Tree"], cfg_mv, make_low=make_low,
                                   make_particles=make_particles)


def packed_row_pair(ds, row, dev, seed):
    """One packed row of ``ds``'s events (1, S) and the same events unpacked
    (n, 128-aligned longest), with the same per-cell noise x0 (and one t for
    all): the model-level equivalence of the two layouts."""
    from superresolutionhep_tpu_torch.data.packing import PackedBatch, aligned_len, collate_packed
    from superresolutionhep_tpu_torch.data.sr_dataset import MODEL_BATCH_KEYS, collate
    from superresolutionhep_tpu_torch.inference.sr import PACKED_BATCH_KEYS, batch_to_device

    row = sorted(row, key=lambda r: r[1])
    events = {i: ds.get_event(i) for i, _, _ in row}
    hp = collate_packed(events, PackedBatch(rows=[row]), S=PACKED_S)
    hu = collate([events[i] for i, _, _ in row], aligned_len(max(n for _, _, n in row)))
    x0p = np.random.default_rng(seed).normal(size=hp["target"].shape).astype(np.float32)
    x0u = np.zeros_like(hu["target"])
    for j, (_, off, n) in enumerate(row):
        x0u[j, :n] = x0p[0, off: off + n]
    bp, bu = batch_to_device(hp, dev, PACKED_BATCH_KEYS), batch_to_device(hu, dev, MODEL_BATCH_KEYS)
    return (bp, torch.from_numpy(x0p).to(dev)), (bu, torch.from_numpy(x0u).to(dev)), row


def layout_errs(vp, vu, row):
    """max over the row's events of |packed - unpacked|: absolute, and over
    max |unpacked|."""
    vp, vu = vp.float(), vu.float()
    err = max(float((vp[0, off: off + n] - vu[j, :n]).abs().max()) for j, (_, off, n) in enumerate(row))
    return {"abs": err, "rel": err / max(float(vu.abs().max()), 1e-12)}


def packed_layout(seed=7):
    """One (8, 5120) packed batch from ``pack_events`` over the multi-particle
    length mix (432-4864 cells), seeded: events of an exact multiple of 128
    cells, events ending inside a 64-cell tile, a row holding one 4864-cell
    event alone, and one empty row.  Returns (layout, seg (8, 5120) int32
    numpy, the events' lengths)."""
    from superresolutionhep_tpu_torch.data.packing import pack_events

    fixed = [4864, 2048, 1024, 640, 432]
    for attempt in range(1000):  # the first seeded draw that fills exactly 7 rows
        rng = np.random.default_rng(seed + attempt)
        lens = fixed + [int(x) for x in rng.integers(432, 4865, size=int(rng.integers(4, 10)))]
        lay = pack_events(lens, S=PACKED_S, rows_per_batch=PACKED_ROWS)
        if len(lay) == 1 and sum(1 for r in lay[0].rows if r) == PACKED_ROWS - 1:
            break
    seg = np.full((PACKED_ROWS, PACKED_S), -1, np.int32)  # as collate_packed numbers segments
    for b, row in enumerate(lay[0].rows):
        for si, (_, off, n) in enumerate(sorted(row, key=lambda r: r[1])):
            seg[b, off: off + n] = si
    return lay[0], seg, lens


def packed_kernel_cases(reps):
    """K7 (robust with LSE, no-max), K8 and K9 against ``_ref_packed_*`` on the
    same CUDA tensors (the backward from K7's own LSE), bf16 and fp32, with
    exact zeros at padding: timed at (B, S, H, D) = (8, 5120, 4, 64) on the
    ``packed_layout`` rows; untimed on two rows whose segment boundaries fall
    inside 64-cell tiles (the packer aligns events to 128 cells, so only such
    rows put two segments into one tile and test the segment mask itself, not
    just the band).  Then autograd through ``packed_flash_attention`` (K7 + K8
    + K9) against autograd through the dense natural-base reference.  Times by
    CUDA-graph replay; library yardstick: one SDPA call with the (B, 1, S, S)
    block-diagonal boolean mask (forward), its memory-efficient backward as
    (fwd+bwd) - fwd."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from superresolutionhep_tpu_torch.ops import flash_packed as fp
    from superresolutionhep_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(777)
    H, D = 4, 64

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    def rel_err(a, b):
        return ((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-12)).item()

    lay, seg_np, lens = packed_layout()
    emit({"phase": "packed_layout", "rows": [[n for _, _, n in sorted(r, key=lambda x: x[1])] for r in lay.rows],
          "S": PACKED_S})
    unaligned = np.full((2, 1024), -1, np.int32)  # boundaries at 300, 584 (inside tiles), padding from 1000
    unaligned[0, :300], unaligned[0, 300:584], unaligned[0, 584:1000] = 0, 1, 2
    unaligned[1, :700] = 0

    def run_layout(seg_host, dtype, timed):
        seg = torch.from_numpy(seg_host).to(dev)
        B, S = seg.shape
        pad = seg < 0
        valid_q = (~pad)[:, None, :].expand(B, H, S)
        seg_lens = [int((seg_host[b] == i).sum()) for b in range(B) for i in range(int(seg_host[b].max()) + 1)]
        sq = float(sum(n * n for n in seg_lens))  # same-segment (query, key) pairs
        dname = "bf16" if dtype == torch.bfloat16 else "fp32"
        isz = 2 if dtype == torch.bfloat16 else 4
        peak = H100_FLOPS[dtype]
        layout = "packed" if timed else "unaligned"

        def zero_at_pad(t):  # (B, S, H, D)
            return float(t.float()[pad].abs().max()) == 0.0

        qkv = randn(B, S, 3, H, D)
        qkv[:, :, 0] *= (1.0 / D**0.5) * fp.LOG2E * 2.0
        qkv = qkv.to(dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # (B, S, H, D) strided views, as the fused buffer gives
        qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
        amask = ((seg[:, :, None] == seg[:, None, :]) & (~pad)[:, None, :])[:, None]  # yardstick only
        out_cases = []
        tol = TOL[("flash", dtype)]
        nbytes_fwd = 4 * B * S * H * D * isz + B * S * 4
        robust_ref = None
        for name, nomax in (("packed_fwd", False), ("packed_fwd_nomax", True)):
            before = kernels.LAUNCHES[name]
            out, lse = fp._packed_fwd(q, k, v, seg, nomax=nomax, with_lse=not nomax)
            torch.cuda.synchronize()
            if kernels.LAUNCHES[name] != before + 1:
                fail(f"{name}: the wrapper did not count its launch")
            ref = fp._ref_packed_fwd(qh, kh, vh, seg, "nomax_clip" if nomax else "max", with_lse=not nomax)
            ref_out, ref_lse = ref if not nomax else (ref, None)
            ref_out = ref_out.permute(0, 2, 1, 3)
            err = rel_err(out, ref_out)
            case = {"kernel": name, "dtype": dname, "layout": layout, "B": B, "H": H, "L": S, "D": D,
                    "max_abs_err": (out.float() - ref_out.float()).abs().max().item(), "max_rel_err": err,
                    "tol_rel": tol, "padding_exactly_zero": zero_at_pad(out)}
            ok = bool(torch.isfinite(out.float()).all()) and err <= tol and case["padding_exactly_zero"]
            if not nomax:
                lerr = (lse - ref_lse)[valid_q].abs().max().item()
                case["lse_max_abs_err_valid"], case["lse_tol"] = lerr, TOL[("lse", dtype)]
                ok = ok and lerr <= TOL[("lse", dtype)]
                robust_ref = ref_out.float()
                fwd_out, fwd_lse = out, lse
            elif dtype == torch.bfloat16:
                xerr = (out.float() - robust_ref).abs().max().item()
                case["vs_robust_max_abs_err"], case["vs_robust_tol"] = xerr, TOL[("nomax_vs_robust", dtype)]
                ok = ok and xerr <= TOL[("nomax_vs_robust", dtype)]
            if timed:
                flops = 4.0 * H * D * sq
                case["ms"] = time_ms(lambda: fp._packed_fwd(q, k, v, seg, nomax=nomax, with_lse=not nomax), reps)
                case["plain_ms"] = time_ms(
                    lambda: fp._ref_packed_fwd(qh, kh, vh, seg, "nomax_clip" if nomax else "max", with_lse=not nomax),
                    max(3, reps // 5))
                qc, kc, vc = (t.contiguous() for t in (qh, kh, vh))
                case["library_ms"] = time_ms(
                    lambda: torch.nn.functional.scaled_dot_product_attention(qc, kc, vc, attn_mask=amask,
                                                                             scale=fp.LN2), reps)
                if dtype == torch.bfloat16:
                    case.update(fwd_bounds(flops, nbytes_fwd, H * sq, peak))
                else:
                    case.update(fp32_attention_bounds(flops, nbytes_fwd, H * sq))
            case["ok"] = ok
            out_cases.append(case)
            emit({"phase": "kernel_case", **case})

        # K8 / K9 from K7's own residuals
        gr = randn(B, S, H, D).to(dtype) * (~pad)[:, :, None, None].to(dtype)
        dl = (fwd_out.float() * gr.float()).sum(-1).transpose(1, 2).contiguous()
        args = (q, k, v, gr, fwd_lse, dl, seg)
        gh = gr.permute(0, 2, 1, 3)
        ref_args = (qh, kh, vh, gh, fwd_lse, dl, seg)
        before = dict(kernels.LAUNCHES)
        dq = fp._packed_bwd_dq_cuda(*args)
        dk, dv = fp._packed_bwd_dkv_cuda(*args)
        torch.cuda.synchronize()
        if (kernels.LAUNCHES["packed_bwd_dq"] != before["packed_bwd_dq"] + 1
                or kernels.LAUNCHES["packed_bwd_dkv"] != before["packed_bwd_dkv"] + 1):
            fail("packed backward: a wrapper did not count its launch")
        ref_dq = fp._ref_packed_bwd_dq(*ref_args).permute(0, 2, 1, 3)
        ref_dk, ref_dv = (t.permute(0, 2, 1, 3) for t in fp._ref_packed_bwd_dkv(*ref_args))
        tol = TOL[("flash_bwd", dtype)]
        nbytes_in = 4 * B * S * H * D * isz + 2 * B * H * S * 4 + B * S * 4
        library_ms = None
        if timed:
            qc, kc, vc = (t.contiguous().requires_grad_(True) for t in (qh, kh, vh))
            gc = gh.contiguous()
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                def lib_fwd():
                    return torch.nn.functional.scaled_dot_product_attention(qc, kc, vc, attn_mask=amask, scale=fp.LN2)

                def lib_fwd_bwd():
                    return torch.autograd.grad(lib_fwd(), (qc, kc, vc), gc)

                library_ms = time_ms(lib_fwd_bwd, reps) - time_ms(lambda: lib_fwd().detach(), reps)
        for name, got, ref, flops, nbytes, fn, plain in (
            ("packed_bwd_dq", (dq,), (ref_dq,), 6.0 * H * D * sq, nbytes_in + B * S * H * D * isz,
             fp._packed_bwd_dq_cuda, fp._ref_packed_bwd_dq),
            ("packed_bwd_dkv", (dk, dv), (ref_dk, ref_dv), 8.0 * H * D * sq, nbytes_in + 2 * B * S * H * D * isz,
             fp._packed_bwd_dkv_cuda, fp._ref_packed_bwd_dkv),
        ):
            errs = [rel_err(a, b) for a, b in zip(got, ref)]
            zeros = all(zero_at_pad(t) for t in got)
            case = {"kernel": name, "dtype": dname, "layout": layout, "B": B, "H": H, "L": S, "D": D,
                    "max_abs_err": max((a.float() - b.float()).abs().max().item() for a, b in zip(got, ref)),
                    "max_rel_err": max(errs), "tol_rel": tol, "padding_exactly_zero": zeros}
            if timed:
                case.update({"ms": time_ms(lambda: fn(*args), reps),
                             "plain_ms": time_ms(lambda: plain(*ref_args), max(3, reps // 5)),
                             "library_ms": library_ms, "library_covers": "dq+dk+dv"})
                if dtype == torch.bfloat16:
                    case["bound_ms"] = max(flops / peak, nbytes / H100_BYTES_PER_S) * 1e3
                    case["bound_by"] = "operations" if flops / peak >= nbytes / H100_BYTES_PER_S else "bytes"
                    case["sfu_bound_ms"] = H * sq / sfu_per_s() * 1e3
                else:
                    case.update(fp32_attention_bounds(flops, nbytes, H * sq))
            case["ok"] = bool(all(torch.isfinite(t.float()).all() for t in got)) and max(errs) <= tol and zeros
            out_cases.append(case)
            emit({"phase": "kernel_case", **case})
        return out_cases

    cases = []
    for dtype in (torch.bfloat16, torch.float32):
        cases += run_layout(seg_np, dtype, timed=True)
        torch.cuda.empty_cache()
        cases += run_layout(unaligned, dtype, timed=False)

    # autograd: packed_flash_attention (K7 with LSE, K8, K9) against the dense
    # natural-base reference, fp32, on the unaligned rows
    segs = torch.from_numpy(unaligned).to(dev)
    x = [randn(2, 1024, H, D).requires_grad_(True) for _ in range(3)]
    w = randn(2, 1024, H, D)
    before = dict(kernels.LAUNCHES)
    out = fp.packed_flash_attention(*x, segs, scale=D**-0.5)
    got = torch.autograd.grad((out * w).sum(), x)
    torch.cuda.synchronize()
    launched = {k: kernels.LAUNCHES[k] - before[k] for k in ("packed_fwd", "packed_bwd_dq", "packed_bwd_dkv")}
    want = torch.autograd.grad((fp.ref_packed_attention(*x, segs, D**-0.5) * w).sum(), x)
    errs = [rel_err(a, b) for a, b in zip(got, want)]
    tol = TOL[("flash_grad", torch.float32)]
    case = {"kernel": "packed_autograd", "dtype": "fp32", "layout": "unaligned", "B": 2, "H": H, "L": 1024, "D": D,
            "max_rel_err_dq_dk_dv": errs, "tol_rel": tol, "launches": launched,
            "ok": max(errs) <= tol and all(n == 1 for n in launched.values())}
    cases.append(case)
    emit({"phase": "kernel_case", **case})

    bad = [c for c in cases if not c["ok"]]
    if bad:
        fail(f"{len(bad)} packed case(s) disagree with the plain version: "
             + "; ".join(f"{c['kernel']}/{c['dtype']}/{c['layout']}" for c in bad))
    return cases


# ---------------------------------------------------------------------------
# phase: train
# ---------------------------------------------------------------------------


def _grads_agree(ga, gb, tol):
    """Each leaf within ``tol`` of max(its own max, 1e-3 of the largest leaf);
    returns (ok, worst relative error, its leaf)."""
    top = max(float(g.abs().max()) for g in gb.values())
    worst, where = 0.0, None
    for k, b in gb.items():
        err = float((ga[k].float() - b.float()).abs().max()) / max(float(b.abs().max()), 1e-3 * top, 1e-30)
        if err > worst:
            worst, where = err, k
    return worst <= tol, worst, where


def profile_steps(step, n):
    """Device time of ``n`` calls of ``step`` by ``torch.profiler`` (CUPTI):
    the wall time, the summed kernel time, the busy share and the kernels
    that take the most time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    by_name, n_kernels = {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
            n_kernels += 1
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"steps": n, "wall_ms_per_step": wall_us / n / 1e3, "device_ms_per_step": busy / n / 1e3,
            "busy_share": busy / wall_us, "kernels_per_step": n_kernels / n,
            "top": [{"name": k[:90], "ms_per_step": v / n / 1e3, "share_of_device": v / max(busy, 1e-9)}
                    for k, v in top]}


def train_phase(reps):
    """SRTrainer at the full width of the multipart model (6 DiT layers,
    h=256, 4 heads of 64), the production training settings (bf16 compute,
    fp32 parameters, per-layer remat, unfused), seeded random init, synthetic
    events in memory: ``fit`` for two epochs with dopri5 validation and
    checkpoints, then a second trainer resumes for a third epoch.  Then one
    fp32 step's gradients through the flash kernels against the dense path,
    and the fused prologue against the unfused layer; then train-step times
    at the two shapes the JAX package's bench times."""
    import copy
    import tempfile

    from superresolutionhep_tpu_torch.configs import MULTIPART_CONFIG_MV, MULTIPART_CONFIG_T
    from superresolutionhep_tpu_torch.data.sr_dataset import MODEL_BATCH_KEYS, collate
    from superresolutionhep_tpu_torch.ops import kernels
    from superresolutionhep_tpu_torch.tools.convert import init_params_jax_layout, params_from_jax
    from superresolutionhep_tpu_torch.train.checkpoint import CheckpointManager
    from superresolutionhep_tpu_torch.train.sr_trainer import SRTrainer

    dev = torch.device("cuda")
    cfg_mv = copy.deepcopy(MULTIPART_CONFIG_MV)
    fm = cfg_mv["flow_model"]
    n_layers = int(fm["transformer"]["num_transformer_layers"])
    cfg_t = dict(copy.deepcopy(MULTIPART_CONFIG_T), n_event_displays=0, num_epochs=2, remat=True,
                 fused_prologue=False, num_workers=2)

    def dataset(n, seed, **kw):
        return multipart_dataset(cfg_mv, n, seed, **kw)

    train_ds = dataset(48, 11, max_particles=4, window_lr_cells=2)
    val_ds = dataset(8, 12, max_particles=4, window_lr_cells=2)
    run = tempfile.mkdtemp(prefix="srhep_train_")
    checks, line = {}, {"phase": "train", "run_dir": run, "n_train_events": len(train_ds),
                        "n_val_events": len(val_ds), "cells": [min(train_ds.cell_count_high),
                                                                max(train_ds.cell_count_high)]}

    calls = {"train": 0, "val": 0}

    def count_calls(_module, _inputs):
        calls["train" if torch.is_grad_enabled() else "val"] += 1

    # ---- the counted window: fit, every count to 0 just before, read just after
    tr = SRTrainer(cfg_mv, cfg_t, run_dir=run, seed=0, dtype=torch.bfloat16, device="cuda")
    hook = tr.model.register_forward_pre_hook(count_calls)
    kernels.reset_launches()
    t0 = time.time()
    tr.fit(train_ds, val_ds)
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    fit_s = time.time() - t0
    # ---- end of the counted window
    hook.remove()
    expect = dict({k: 0 for k in kernels.LAUNCHES},
                  flash_fwd=n_layers * (2 * calls["train"] + calls["val"]),  # remat: forward + recompute
                  flash_bwd_dq=n_layers * calls["train"], flash_bwd_dkv=n_layers * calls["train"])
    lines = [json.loads(x) for x in open(f"{run}/metrics.jsonl")]
    checks["fit_epochs"] = tr.epoch == 2 and len(lines) == 2
    checks["losses_finite"] = all(np.isfinite(x["train/loss"]) and x["train/nonfinite"] == 0.0
                                  and np.isfinite(x["val/loss_raw"]) for x in lines)
    checks["launch_counts"] = counts == expect
    checks["validation_ran_dopri5_through_k1"] = calls["val"] > 0 and counts["flash_fwd"] > 2 * n_layers * calls["train"]
    line.update({"fit_s": round(fit_s, 2), "train_steps": tr.global_step, "model_calls": dict(calls),
                 "launches": counts, "launches_expected": expect,
                 "epochs": [{k: x[k] for k in ("step", "lr", "train/loss", "train/grad_norm", "train/n_batches",
                                               "train/epoch_s", "val/loss", "val/loss_raw")} for x in lines]})

    # ---- resume: a new trainer restores the last checkpoint and trains epoch 2
    final = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
    ck = CheckpointManager(f"{run}/checkpoints")
    restored = ck.restore(which="last", map_location=dev)["params"]
    latest_before = ck.latest_step()
    tr2 = SRTrainer(cfg_mv, dict(cfg_t, num_epochs=3), run_dir=run, seed=1, dtype=torch.bfloat16, device="cuda")
    tr2.fit(train_ds, val_ds, resume=True)
    lines = [json.loads(x) for x in open(f"{run}/metrics.jsonl")]
    checks["resume_restored_last_epoch"] = (
        latest_before == 1 and all(torch.equal(restored[k], final[k]) for k in final)
        and tr2.epoch == 3 and lines[-1]["step"] == 2 and tr2.opt.count == tr.opt.count + tr2.global_step
    )
    checks["best3_kept"] = len(CheckpointManager(f"{run}/checkpoints").all_best_steps()) == 3
    line["resume"] = {"latest_step_before": latest_before, "steps_after": tr2.global_step, "epoch_after": tr2.epoch,
                      "val_loss_raw": lines[-1].get("val/loss_raw")}
    del tr, tr2

    # ---- one fp32 step at (B=2, L=512): flash kernels vs the dense path, fused vs unfused
    small = dataset(2, 13, min_particles=1, max_particles=1, window_lr_cells=1)
    hb = collate([small.get_event(i) for i in range(2)], 512)
    batch = {k: torch.from_numpy(hb[k]).to(dev) for k in MODEL_BATCH_KEYS}
    gcpu = torch.Generator().manual_seed(5)
    x0 = torch.randn(batch["target"].shape, generator=gcpu).to(dev)
    t = torch.rand((2,), generator=gcpu).to(dev)
    params = params_from_jax(init_params_jax_layout(fm, seed=3), fm)  # Xavier adaLN: attention not gated off
    grads = {}
    for name, impl, fused in (("flash", "flash", False), ("einsum", "einsum", False), ("fused", "flash", True)):
        trx = SRTrainer(cfg_mv, dict(cfg_t, fused_prologue=fused), run_dir=tempfile.mkdtemp(), seed=0,
                        device="cuda", params=params, attn_impl=impl)
        before = dict(kernels.LAUNCHES)
        loss, _, g = trx.loss_and_grads(batch, t=t, x0=x0)
        torch.cuda.synchronize()
        grads[name] = ({n: gi for (n, _), gi in zip(trx.model.named_parameters(), g)}, float(loss.detach()),
                       {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES})
        del trx
    tol = 1e-3
    ok_fe, err_fe, leaf_fe = _grads_agree(grads["flash"][0], grads["einsum"][0], tol)
    ok_fu, err_fu, leaf_fu = _grads_agree(grads["fused"][0], grads["flash"][0], tol)
    checks["flash_vs_einsum_grads_fp32"] = ok_fe and grads["flash"][2]["flash_bwd_dq"] == n_layers
    # remat: the fused kernels run in the forward and again in the recompute
    checks["fused_vs_unfused_grads_fp32"] = ok_fu and grads["fused"][2]["fused_qkv"] == 2 * n_layers
    line["grad_checks"] = {
        "tol_rel": tol, "flash_vs_einsum": {"worst_rel_err": err_fe, "leaf": leaf_fe,
                                            "loss": [grads["flash"][1], grads["einsum"][1]]},
        "fused_vs_unfused": {"worst_rel_err": err_fu, "leaf": leaf_fu,
                             "loss": [grads["fused"][1], grads["flash"][1]]},
        "launches": {k: {n: c for n, c in v[2].items() if c} for k, v in grads.items()}}

    # ---- train-step time at the JAX package's bench shapes (a reading, not a benchmark)
    steps = []
    for B, N in ((8, 2048), (6, 3584)):
        trs = SRTrainer(cfg_mv, dict(cfg_t, lr_scheduler=None), run_dir=tempfile.mkdtemp(), seed=0,
                        dtype=torch.bfloat16, device="cuda")
        rng = np.random.default_rng(0)
        host = {
            "eta": rng.normal(size=(B, N, 1)).astype(np.float32),
            "cosphi": rng.normal(size=(B, N, 1)).astype(np.float32),
            "sinphi": rng.normal(size=(B, N, 1)).astype(np.float32),
            "layer": rng.integers(0, 3, size=(B, N, 1)).astype(np.int32),
            "e_proxy": rng.normal(size=(B, N, 1)).astype(np.float32),
            "q_mask": np.ones((B, N), bool),
            "target": rng.normal(size=(B, N, 1)).astype(np.float32),
        }
        b = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
        for _ in range(2):
            trs.train_step(b, lr=1e-3)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(max(5, reps // 4)):
            t1 = time.time()
            st = trs.train_step(b, lr=1e-3)
            float(st["loss"])
            ms.append((time.time() - t1) * 1e3)
        steps.append({"B": B, "N": N, "median_ms": statistics.median(ms), "min_ms": min(ms), "max_ms": max(ms),
                      "n": len(ms), "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "finite": bool(np.isfinite(float(st["loss"]))),
                      "profile": profile_steps(lambda: trs.train_step(b, lr=1e-3), 3)})
        del trs, b
    checks["step_times_finite"] = all(s["finite"] for s in steps)
    line["train_step_ms"] = steps
    line["checks"], line["ok"] = checks, all(checks.values())
    emit(line)
    if not line["ok"]:
        fail("train checks failed: " + ", ".join(k for k, v in checks.items() if not v))
    return counts


# ---------------------------------------------------------------------------
# phase: packed inference
# ---------------------------------------------------------------------------


def packed_inference_phase():
    """``SRInference.predict`` with ``packed: true`` at the full width of the
    multipart model (bf16, 25-point grid, 10 ensemble members, rows of 5120
    cells, 8 rows a batch) on 48 synthetic events: the fast model (no-max
    packed kernel behind the first-batch self-check, fused prologue and MLP)
    in the counted window, then the robust model; a small run whose pack_s
    lies below the largest events, so that they take the bucketed mop-up;
    the copied branches against a bucketed run of the same events; one model
    evaluation of a packed row against the same events unpacked (K7 vs K1)."""
    import copy

    from superresolutionhep_tpu_torch.configs import MULTIPART_CONFIG_MV, MULTIPART_CONFIG_T, serve_inference_config
    from superresolutionhep_tpu_torch.data.bucketing import BucketBatcher
    from superresolutionhep_tpu_torch.data.packing import aligned_len, collate_packed, pack_events
    from superresolutionhep_tpu_torch.inference.sr import PACKED_BATCH_KEYS, SRInference, batch_to_device
    from superresolutionhep_tpu_torch.models.flow_model import FlowModel
    from superresolutionhep_tpu_torch.ops import kernels
    from superresolutionhep_tpu_torch.tools.convert import init_params_jax_layout, params_from_jax

    dev = torch.device("cuda")
    cfg_mv = copy.deepcopy(MULTIPART_CONFIG_MV)
    flow_cfg = cfg_mv["flow_model"]
    n_layers = int(flow_cfg["transformer"]["num_transformer_layers"])
    params = params_from_jax(init_params_jax_layout(flow_cfg, seed=0), flow_cfg)
    ds = multipart_dataset(cfg_mv, 48, 21, make_low=True, make_particles=True, max_particles=4, window_lr_cells=2)
    counts = ds.cell_count_high
    inf_dict = {"n_ensemble": 10, "ode_method": "ab2e", "seed": 0, "batch_size": 8}
    packing = dict(packed=True, pack_s=PACKED_S, pack_rows=PACKED_ROWS)
    n_packed = len(pack_events(counts, S=PACKED_S, rows_per_batch=PACKED_ROWS))
    zero = {k: 0 for k in kernels.LAUNCHES}
    checks, line = {}, {"phase": "packed_inference", "n_events": len(ds), "cells": [min(counts), max(counts)],
                        "packed_batches": n_packed, "S": PACKED_S, "rows": PACKED_ROWS}

    # ---- the counted window: the fast model, every count to 0 just before, read just after
    inf = SRInference(serve_inference_config(cfg_mv, **packing), params=params, device="cuda")
    per_call = n_layers * (inf.n_steps - 1)  # ab2e: one evaluation per grid interval
    kernels.reset_launches()
    t0 = time.time()
    fast = inf.predict(ds, inf_dict)
    torch.cuda.synchronize()
    counts_fast = dict(kernels.LAUNCHES)
    fast_s = time.time() - t0
    # ---- end of the counted window
    expect_fast = dict(zero, packed_fwd=n_layers,  # the self-check's robust model
                       packed_fwd_nomax=per_call * n_packed + n_layers, fused_qkv=per_call * n_packed + n_layers,
                       fused_mlp=per_call * n_packed + n_layers,
                       packed_band=per_call * n_packed + 2 * n_layers)  # one per bf16 K7 launch
    checks["selfcheck_passed"] = inf.nomax_selfcheck_passed is True and inf.fast_softmax is True
    checks["launch_counts_fast"] = counts_fast == expect_fast

    # where the time goes: one sampler call of the first packed batch under torch.profiler
    lay0 = pack_events(counts, S=PACKED_S, rows_per_batch=PACKED_ROWS)[0]
    b0 = batch_to_device(collate_packed({i: ds.get_event(i) for r in lay0.rows for i, _, _ in r}, lay0, S=PACKED_S),
                         dev, PACKED_BATCH_KEYS)
    gen = torch.Generator(device=dev).manual_seed(0)
    line["profile_sampler_call"] = profile_steps(
        lambda: inf._gen(b0, gen, n_ensemble=10, n_steps=inf.n_steps, method="ab2e", fast=True), 1)
    line["profile_sampler_call"]["valid_cells"] = int(b0["q_mask"].sum())
    del b0

    robust_inf = SRInference(serve_inference_config(cfg_mv, fast_softmax=False, **packing), params=params,
                                   device="cuda")
    kernels.reset_launches()
    t0 = time.time()
    robust = robust_inf.predict(ds, inf_dict)
    torch.cuda.synchronize()
    counts_robust = dict(kernels.LAUNCHES)
    robust_s = time.time() - t0
    checks["launch_counts_robust"] = counts_robust == dict(zero, packed_fwd=per_call * n_packed,
                                                           packed_band=per_call * n_packed)
    ht_f, ht_r = fast["High_Tree"], robust["High_Tree"]
    checks["predictions_finite"] = all(bool(np.isfinite(t["High_Tree"][k].flat).all()) for t in (fast, robust)
                                       for k in ("e_pred_raw", "raw_nn_pred"))
    checks["one_row_per_event"] = all(len(t["High_Tree"]["e_pred_raw"]) == len(ds) for t in (fast, robust))
    raw_diff = float(np.abs(ht_f["raw_nn_pred"].flat - ht_r["raw_nn_pred"].flat).max())
    checks["robust_agrees_raw_nn_pred"] = raw_diff <= 6e-2

    # ---- the copied branches against a bucketed run of the same events (one
    # evaluation per batch, one member: the branches do not depend on the sampler)
    bucketed = SRInference(serve_inference_config(cfg_mv, n_steps=2, fast_softmax=False), params=params,
                                 device="cuda").predict(ds, dict(inf_dict, n_ensemble=1))
    same = True
    for tree in ("Low_Tree", "High_Tree", "Particle_Tree"):
        for k, b in bucketed[tree].items():
            if k.startswith(("e_pred", "raw_nn_pred")):
                continue
            a = fast[tree][k]
            same = same and np.array_equal(a.offsets, b.offsets) and np.array_equal(a.flat, b.flat)
    checks["copied_branches_equal_bucketed"] = bool(same)

    # ---- mop-up: pack_s below the largest events
    small = multipart_dataset(cfg_mv, 6, 22, make_low=True, make_particles=True, max_particles=4, window_lr_cells=2)
    sc = np.asarray(small.cell_count_high)
    pack_s = 2048
    fits = np.array([aligned_len(int(n)) <= pack_s for n in sc])
    n_pk = len(pack_events(sc[fits], S=pack_s, rows_per_batch=2))
    n_mop = len(list(BucketBatcher(sc[~fits], quantum=int(MULTIPART_CONFIG_T["bucket_quantum"]), max_batch_size=8,
                                   shuffle=False, tail_shrink="exact")))
    mop_inf = SRInference(serve_inference_config(cfg_mv, packed=True, pack_s=pack_s, pack_rows=2),
                                params=params, device="cuda")
    kernels.reset_launches()
    mop = mop_inf.predict(small, dict(inf_dict, n_ensemble=2))
    torch.cuda.synchronize()
    counts_mop = dict(kernels.LAUNCHES)
    expect_mop = dict(zero, packed_fwd=n_layers, packed_fwd_nomax=per_call * n_pk + n_layers,
                      packed_band=per_call * n_pk + 2 * n_layers,
                      flash_fwd_nomax=per_call * n_mop, fused_qkv=per_call * (n_pk + n_mop) + n_layers,
                      fused_mlp=per_call * (n_pk + n_mop) + n_layers)
    checks["mopup_ran"] = n_pk > 0 and n_mop > 0 and counts_mop == expect_mop
    checks["mopup_finite_in_order"] = (
        bool(np.isfinite(mop["High_Tree"]["e_pred_raw"].flat).all())
        and [len(x) for x in mop["High_Tree"]["e_pred_raw"]] == list(sc))

    # ---- one evaluation of a packed row against the same events unpacked
    # the row holding the most events (several segments side by side)
    row = max((r for b in pack_events(counts, S=PACKED_S, rows_per_batch=PACKED_ROWS) for r in b.rows), key=len)
    (bp, xp), (bu, xu), row = packed_row_pair(ds, row, dev, seed=5)
    fp32_model = FlowModel(flow_cfg).to(dev)
    fp32_model.load_reference_state_dict(params)
    fp32_model.eval().requires_grad_(False)
    layouts = {}
    for name, model, dtype in (("bf16", robust_inf.model, torch.bfloat16), ("fp32", fp32_model, torch.float32)):
        before = dict(kernels.LAUNCHES)
        with torch.no_grad():
            vp = model(bp, xp, torch.full((1,), 0.5, device=dev))
            vu = model(bu, xu, torch.full((len(row),), 0.5, device=dev))
        torch.cuda.synchronize()
        launched = {k: kernels.LAUNCHES[k] - before[k] for k in ("packed_fwd", "flash_fwd")}
        errs = layout_errs(vp, vu, row)
        kind, tol = LAYOUT_TOL[dtype]
        layouts[name] = {"max_abs_err": errs["abs"], "max_rel_err": errs["rel"], f"tol_{kind}": tol,
                         "launches": launched}
        checks[f"packed_row_equals_unpacked_{name}"] = errs[kind] <= tol and launched == {"packed_fwd": n_layers,
                                                                                         "flash_fwd": n_layers}

    line.update({"fast_s": round(fast_s, 2), "robust_s": round(robust_s, 2),
                 "sampler_calls": n_packed, "launches_per_sampler_call": per_call,
                 "launches": counts_fast, "launches_expected": expect_fast, "launches_robust": counts_robust,
                 "robust_vs_fast_raw_nn_pred_max_abs": raw_diff, "robust_vs_fast_tol": 6e-2,
                 "mopup": {"pack_s": pack_s, "cells": sc.tolist(), "packed_calls": n_pk, "bucketed_calls": n_mop,
                           "launches": counts_mop},
                 "packed_row_vs_unpacked": {"events": [n for _, _, n in row], **layouts},
                 "checks": checks, "ok": all(checks.values())})
    emit(line)
    if not line["ok"]:
        fail("packed inference checks failed: " + ", ".join(k for k, v in checks.items() if not v))
    return counts_fast


# ---------------------------------------------------------------------------
# phase: dopri5 over a folded ensemble
# ---------------------------------------------------------------------------

# dopri5 over a folded ensemble (fp32, the flash kernels): a member's result may
# not depend on the other members (same batch shape, so the same kernels and
# the same rounding: bitwise, held to 1e-6 of the largest |x|); against the
# member run alone (other shapes, so other GEMM roundings, ~1e-6, which can
# flip a step decision near err = 1 and move a grid value by the solver's
# tolerance): 1e-3 of the largest |x|
DOPRI5_TOL = {"independent": 1e-6, "single": 1e-3}


def dopri5_ensemble_phase():
    """One ``generate_ensemble(method="dopri5")`` call of the multipart model
    (random weights, fp32, flash kernels) on two synthetic events with three
    members, and again with the other members' noise drawn anew: member 0
    must not move, as each member keeps its own step-size control (a control
    shared by the members moves it by the solver's tolerance, ~1e-4).  Then
    each member against ``generate_samples`` of that member alone."""
    import copy

    from superresolutionhep_tpu_torch.configs import MULTIPART_CONFIG_MV
    from superresolutionhep_tpu_torch.data.packing import aligned_len
    from superresolutionhep_tpu_torch.data.sr_dataset import MODEL_BATCH_KEYS, collate
    from superresolutionhep_tpu_torch.flow.sampling import generate_ensemble, generate_samples
    from superresolutionhep_tpu_torch.inference.sr import batch_to_device
    from superresolutionhep_tpu_torch.models.flow_model import FlowModel
    from superresolutionhep_tpu_torch.tools.convert import init_params_jax_layout, params_from_jax

    dev = torch.device("cuda")
    cfg_mv = copy.deepcopy(MULTIPART_CONFIG_MV)
    flow_cfg = cfg_mv["flow_model"]
    model = FlowModel(flow_cfg).to(dev)
    model.load_reference_state_dict(params_from_jax(init_params_jax_layout(flow_cfg, seed=0), flow_cfg))
    model.eval().requires_grad_(False)
    ds = multipart_dataset(cfg_mv, 8, 41)
    small = sorted(range(len(ds)), key=lambda i: ds.cell_count_high[i])[:2]
    events = [ds.get_event(i) for i in small]
    batch = batch_to_device(collate(events, aligned_len(max(ds.cell_count_high[i] for i in small))), dev,
                            MODEL_BATCH_KEYS)
    E, n_steps = 3, 6
    gen = torch.Generator(device=dev).manual_seed(3)
    x0 = torch.randn((E, *batch["e_proxy"].shape), generator=gen, device=dev)
    x0b = x0.clone()
    x0b[1:] = torch.randn(x0b[1:].shape, generator=gen, device=dev)
    calls = [0]

    def apply(b, x, t):
        calls[0] += 1
        return model(b, x, t)

    t0 = time.time()
    ens = generate_ensemble(apply, batch, E, n_steps, method="dopri5", ret_seq=False, x0=x0)
    torch.cuda.synchronize()
    ens_s, ens_calls = time.time() - t0, calls[0]
    ens_b = generate_ensemble(apply, batch, E, n_steps, method="dopri5", ret_seq=False, x0=x0b)
    valid = batch["q_mask"]
    scale = float(ens[:, valid].abs().max())
    indep = float((ens[0] - ens_b[0])[valid].abs().max())
    single = [float((ens[e] - generate_samples(apply, batch, n_steps, method="dopri5", x0=x0[e]))[valid].abs().max())
              for e in range(E)]
    checks = {"finite": bool(torch.isfinite(ens).all()),
              "member_independent_of_the_others": indep <= DOPRI5_TOL["independent"] * scale,
              "members_match_single_runs": max(single) <= DOPRI5_TOL["single"] * scale}
    line = {"phase": "dopri5_ensemble", "members": E, "events_cells": [int(ds.cell_count_high[i]) for i in small],
            "n_steps": n_steps, "model_evaluations": ens_calls, "seconds": round(ens_s, 2), "scale": scale,
            "member0_max_abs_change_when_others_change": indep, "max_abs_err_vs_single_by_member": single,
            "tol_rel": DOPRI5_TOL, "checks": checks, "ok": all(checks.values())}
    emit(line)
    if not line["ok"]:
        fail("dopri5 ensemble checks failed: " + ", ".join(k for k, v in checks.items() if not v))


# ---------------------------------------------------------------------------
# phase: packed train
# ---------------------------------------------------------------------------


def packed_train_phase(reps):
    """``SRTrainer.fit`` with ``packed: true`` at full width (bf16 compute,
    fp32 parameters, per-layer remat, unfused, rows of 5120 cells, 8 a batch)
    for two epochs, then resumed for a third; one fp32 step of a packed row
    against the same events unpacked (loss and every gradient); the median
    step time at (8, 5120) with a torch.profiler busy share."""
    import copy
    import tempfile

    from superresolutionhep_tpu_torch.configs import MULTIPART_CONFIG_MV, MULTIPART_CONFIG_T
    from superresolutionhep_tpu_torch.data.packing import collate_packed, pack_events
    from superresolutionhep_tpu_torch.inference.sr import PACKED_BATCH_KEYS, batch_to_device
    from superresolutionhep_tpu_torch.ops import kernels
    from superresolutionhep_tpu_torch.tools.convert import init_params_jax_layout, params_from_jax
    from superresolutionhep_tpu_torch.train.checkpoint import CheckpointManager
    from superresolutionhep_tpu_torch.train.sr_trainer import SRTrainer

    dev = torch.device("cuda")
    cfg_mv = copy.deepcopy(MULTIPART_CONFIG_MV)
    fm = cfg_mv["flow_model"]
    n_layers = int(fm["transformer"]["num_transformer_layers"])
    cfg_t = dict(copy.deepcopy(MULTIPART_CONFIG_T), n_event_displays=0, num_epochs=2, remat=True,
                 fused_prologue=False, num_workers=2, packed=True, pack_s=PACKED_S, pack_rows=PACKED_ROWS)
    train_ds = multipart_dataset(cfg_mv, 48, 11, max_particles=4, window_lr_cells=2)
    val_ds = multipart_dataset(cfg_mv, 8, 12, max_particles=4, window_lr_cells=2)
    layouts = pack_events(train_ds.cell_count_high, S=PACKED_S, rows_per_batch=PACKED_ROWS)
    run = tempfile.mkdtemp(prefix="srhep_packed_train_")
    checks, line = {}, {"phase": "packed_train", "run_dir": run, "n_train_events": len(train_ds),
                        "packed_batches_per_epoch": len(layouts), "S": PACKED_S, "rows": PACKED_ROWS}
    calls = {"train": 0, "val": 0}

    def count_calls(_module, _inputs):
        calls["train" if torch.is_grad_enabled() else "val"] += 1

    # ---- the counted window: fit, every count to 0 just before, read just after
    tr = SRTrainer(cfg_mv, cfg_t, run_dir=run, seed=0, dtype=torch.bfloat16, device="cuda")
    hook = tr.model.register_forward_pre_hook(count_calls)
    kernels.reset_launches()
    t0 = time.time()
    tr.fit(train_ds, val_ds)
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    fit_s = time.time() - t0
    # ---- end of the counted window
    hook.remove()
    expect = {k: 0 for k in kernels.LAUNCHES}
    expect.update(packed_fwd=2 * n_layers * calls["train"],  # remat: forward + recompute
                  packed_band=4 * n_layers * calls["train"],  # one per bf16 K7, K8 and K9 launch
                  packed_bwd_dq=n_layers * calls["train"], packed_bwd_dkv=n_layers * calls["train"],
                  flash_fwd=n_layers * calls["val"])  # validation stays bucketed
    lines = [json.loads(x) for x in open(f"{run}/metrics.jsonl")]
    checks["fit_epochs"] = tr.epoch == 2 and len(lines) == 2 and calls["train"] == 2 * len(layouts)
    checks["losses_finite"] = all(np.isfinite(x["train/loss"]) and x["train/nonfinite"] == 0.0
                                  and np.isfinite(x["val/loss_raw"]) for x in lines)
    checks["launch_counts"] = counts == expect
    line.update({"fit_s": round(fit_s, 2), "train_steps": tr.global_step, "model_calls": dict(calls),
                 "launches": counts, "launches_expected": expect,
                 "epochs": [{k: x[k] for k in ("step", "train/loss", "train/grad_norm", "train/n_batches",
                                               "train/epoch_s", "val/loss_raw")} for x in lines]})

    final = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
    ck = CheckpointManager(f"{run}/checkpoints")
    restored = ck.restore(which="last", map_location=dev)["params"]
    tr2 = SRTrainer(cfg_mv, dict(cfg_t, num_epochs=3), run_dir=run, seed=1, dtype=torch.bfloat16, device="cuda")
    tr2.fit(train_ds, val_ds, resume=True)
    lines = [json.loads(x) for x in open(f"{run}/metrics.jsonl")]
    checks["resume_restored_last_epoch"] = (
        all(torch.equal(restored[k], final[k]) for k in final) and tr2.epoch == 3 and lines[-1]["step"] == 2
        and tr2.global_step == len(layouts))
    del tr, tr2

    # ---- one fp32 step: a packed row against the same events unpacked
    row = max((r for b in layouts for r in b.rows), key=len)  # the row holding the most events
    (bp, xp), (bu, xu), row = packed_row_pair(train_ds, row, dev, seed=6)
    params = params_from_jax(init_params_jax_layout(fm, seed=3), fm)  # Xavier adaLN: attention not gated off
    trx = SRTrainer(cfg_mv, cfg_t, run_dir=tempfile.mkdtemp(), seed=0, device="cuda", params=params)
    res = {}
    for name, b, x0 in (("packed", bp, xp), ("unpacked", bu, xu)):
        before = dict(kernels.LAUNCHES)
        t = torch.full((b["target"].shape[0],), 0.37, device=dev)
        loss, _, g = trx.loss_and_grads(b, t=t, x0=x0)
        torch.cuda.synchronize()
        res[name] = ({n: gi for (n, _), gi in zip(trx.model.named_parameters(), g)}, float(loss.detach()),
                     {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES if kernels.LAUNCHES[k] != before[k]})
    tol = 1e-3
    ok, worst, leaf = _grads_agree(res["packed"][0], res["unpacked"][0], tol)
    lp, lu = res["packed"][1], res["unpacked"][1]
    checks["packed_vs_unpacked_grads_fp32"] = (
        ok and abs(lp - lu) <= tol * abs(lu)
        and res["packed"][2] == {"packed_fwd": 2 * n_layers, "packed_bwd_dq": n_layers, "packed_bwd_dkv": n_layers}
        and res["unpacked"][2] == {"flash_fwd": 2 * n_layers, "flash_bwd_dq": n_layers, "flash_bwd_dkv": n_layers})
    line["grad_check"] = {"events": [n for _, _, n in row], "tol_rel": tol, "worst_rel_err": worst, "leaf": leaf,
                          "loss": [lp, lu], "launches": {k: v[2] for k, v in res.items()}}
    del trx

    # ---- train-step time on one packed batch (a reading, not a benchmark)
    trs = SRTrainer(cfg_mv, dict(cfg_t, lr_scheduler=None), run_dir=tempfile.mkdtemp(), seed=0,
                    dtype=torch.bfloat16, device="cuda")
    hb = collate_packed({i: train_ds.get_event(i) for r in layouts[0].rows for i, _, _ in r}, layouts[0], S=PACKED_S)
    b = batch_to_device(hb, dev, PACKED_BATCH_KEYS)
    for _ in range(2):
        trs.train_step(b, lr=1e-3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(max(5, reps // 4)):
        t1 = time.time()
        st = trs.train_step(b, lr=1e-3)
        float(st["loss"])
        ms.append((time.time() - t1) * 1e3)
    step = {"B": PACKED_ROWS, "N": PACKED_S, "valid_cells": int(hb["q_mask"].sum()),
            "events": layouts[0].n_events, "median_ms": statistics.median(ms), "min_ms": min(ms),
            "max_ms": max(ms), "n": len(ms), "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "finite": bool(np.isfinite(float(st["loss"]))),
            "profile": profile_steps(lambda: trs.train_step(b, lr=1e-3), 3)}
    del trs, b
    checks["step_time_finite"] = step["finite"]
    line["train_step_ms"] = step
    line["checks"], line["ok"] = checks, all(checks.values())
    emit(line)
    if not line["ok"]:
        fail("packed train checks failed: " + ", ".join(k for k, v in checks.items() if not v))
    return counts


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
    expect = dict({k: 0 for k in kernels.LAUNCHES},  # serving runs no backward and no packed kernel
                  flash_fwd=n_layers, flash_fwd_nomax=per_call * n_calls + n_layers,
                  fused_qkv=per_call * n_calls + n_layers, fused_mlp=per_call * n_calls + n_layers)

    checks = {
        "nomax_validated": bool(srv.inf._nomax_validated),
        "selfcheck_passed": srv.inf.nomax_selfcheck_passed is True and srv.inf.fast_softmax is True,
        "pair_batched": all(o["batched_with"] == 2 for o in pair_out),
        "fifo_above_batch_max_bucket": all(o["batched_with"] == 1 for _, _, o, _ in results if o["bucket"] > 1024),
        "all_finite_and_sized": all(
            len(o["e_pred_raw"]) == o["n_cells"] == n and bool(np.isfinite(o["e_pred_raw"]).all())
            for _, n, o, _ in results),
        "launch_counts": counts == expect,
        "every_serve_kernel_launched": all(counts[k] > 0 for k in SERVE_KERNELS),
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


# ---------------------------------------------------------------------------
# phase: probes (K10, K11 and the two measuring scripts)
# ---------------------------------------------------------------------------


def max_sm_clock_hz():
    """The card's maximum SM clock, for the special-function unit's bound."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    return float(out) * 1e6


def probe_kernel_cases(reps):
    """K10 (four modes) and K11 (bf16 and fp32 exp; all-ones and ragged key
    masks) against their plain versions on the same CUDA tensors.
      * timed, at the scripts' shapes (8, 8, 2048, 64) and (4, 8, 3584, 64),
        on the default tile (the shipped forward's pick: 192 query rows x 64
        keys on the H100 at both shapes, the last query tile ragged), on the
        scripts' inputs: q fed as q, k and v (scaled by 0.9: |q|^2 ~ 52 +- 9
        keeps the no-max mode's bf16 exp2, which overflows at 128, finite on
        every row);
      * untimed, at (8, 8, 2048, 64), on independent q, k, v: logits of std ~2
        in every mode (the softmax is not the near-identity that q = k = v
        gives), logits of std ~32 in the running-max modes (without the max,
        exp2 overflows), on the default tile, then on every other tile shape
        of ``TILES``.
    Tolerance 1e-2 of each output's max: p is rounded to bf16 on both sides
    (the hardware ex2.approx.bf16x2 against a rounded fp32 exp2, one ulp
    apart at most), another summation order; with the ragged mask, also 1e-2
    of the max of the row with no valid key (its mean of v is small beside
    the output's max, and a kernel that skipped dead tiles would give 0).
    That tolerance cannot tell the
    exponential's dtype apart, so on the independent inputs every bf16/fp32
    exp case must also lie nearer (mean absolute difference) to its own
    mode's plain version than to the other dtype's; both gaps are printed.
    Bounds: operations 4*B*H*L^2*D over the bf16 tensor-core peak, bytes (q,
    k, v, out, km once) over the memory rate, and beside them the
    special-function units' bound: B*H*L^2 exponentials at 16 per clock per
    SM (the maximum SM clock), one per exp2f in the fp32 mode and one per two
    exponentials in the bf16 modes, whose ex2.approx.ftz.bf16x2 yields two
    results; that the bf16x2 instruction issues at the f32 rate is an
    assumption, not a measured or documented figure.
    Library: one SDPA call with scale ln 2 (the same base-2 softmax) and the
    boolean key mask; for matmuls_only two torch.matmul."""
    from superresolutionhep_tpu_torch.ops import attention_probes as ap
    from superresolutionhep_tpu_torch.ops import flash_attention as fa
    from superresolutionhep_tpu_torch.ops import kernels

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2024)
    sfu_per_s = 16 * torch.cuda.get_device_properties(0).multi_processor_count * max_sm_clock_hz()
    peak = H100_FLOPS[torch.bfloat16]

    def randn(B, H, L, scale):
        return (torch.randn((B, H, L, 64), generator=g, device=dev) * scale).to(torch.bfloat16)

    def ragged(B, L):
        """1 = valid: full rows, a row whose valid keys start after the first
        two 64-key tiles (the p = 1 trap wiped by alpha = 0), a row with no
        valid key at all (out = mean of v), ragged ends."""
        km = torch.ones((B, L), device=dev)
        km[1, :160], km[1, 1500:] = 0.0, 0.0
        km[2, :] = 0.0
        km[3, 700:] = 0.0
        return km

    cases = []

    def run(name, inputs, call, plain, extra, timing=None, other=None):
        """Launch once (counted), compare with the plain version; with
        ``other`` (the plain version in the other exp dtype) also require the
        output nearer its own mode's; with ``timing`` = (library, flops,
        sfu_instructions, bytes) also time all three."""
        B, H, L, _ = inputs[0].shape
        before = kernels.LAUNCHES[name]
        out = call()
        torch.cuda.synchronize()
        if kernels.LAUNCHES[name] != before + 1:
            fail(f"{name}: the wrapper did not count its launch")
        ref = plain()
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        scale = ref.float().abs().max().item()
        case = {"kernel": name, "dtype": "bf16", "B": B, "H": H, "L": L, "D": 64, **extra, "max_abs_err": err,
                "max_rel_err": err / max(scale, 1e-30), "tol_rel": PROBE_TOL,
                "plain_finite": bool(torch.isfinite(ref.float()).all())}
        case["ok"] = case["plain_finite"] and bool(torch.isfinite(out.float()).all()) and err <= PROBE_TOL * scale
        if extra.get("mask") == "ragged":  # row 2 has no valid key: the mean of v, where a skipped tile gives 0
            dead = (out[2].float() - ref[2].float()).abs().max().item()
            case["dead_row_rel_err"] = dead / max(ref[2].float().abs().max().item(), 1e-30)
            case["ok"] = case["ok"] and case["dead_row_rel_err"] <= PROBE_TOL
        if other is not None:
            gap = (out.float() - other().float()).abs()
            case["exp_dtype_check"] = {"mean_abs_err_own_dtype": diff.mean().item(),
                                       "mean_abs_err_other_dtype": gap.mean().item(),
                                       "max_abs_err_other_dtype": gap.max().item()}
            case["ok"] = case["ok"] and diff.mean().item() < gap.mean().item()
        if timing is not None:
            library, flops, sfu_ops, nbytes = timing
            case.update({"ms": time_ms(call, reps), "plain_ms": time_ms(plain, max(3, reps // 5)),
                         "library_ms": time_ms(library, reps),
                         "bound_ms": max(flops / peak, nbytes / H100_BYTES_PER_S) * 1e3,
                         "bound_by": "operations" if flops / peak >= nbytes / H100_BYTES_PER_S else "bytes",
                         "sfu_bound_ms": sfu_ops / sfu_per_s * 1e3})
        emit({"phase": "kernel_case", **case})
        cases.append(case)

    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def variant(q, k, v, mode, tag, bq=None, bk=64, timing=None, dtype_check=False):
        bq = bq or fa.fwd_tile_rows(*q.shape[:3], sms)
        swap = {"full": "fp32_exp", "fp32_exp": "full"}
        run("probe_variant", (q, k, v), lambda: ap.attention_variant(q, k, v, mode, block_q=bq, block_k=bk),
            lambda: ap._ref_variant(q, k, v, mode, block_k=bk), {"mode": mode, "blocks": [bq, bk], **tag}, timing,
            (lambda: ap._ref_variant(q, k, v, swap[mode], block_k=bk)) if dtype_check and mode in swap else None)

    def exp_probe(q, k, v, km, exp_bf16, mask, tag, bq=None, bk=64, timing=None, dtype_check=False):
        bq = bq or fa.fwd_tile_rows(*q.shape[:3], sms)
        run("probe_exp_dtype", (q, k, v),
            lambda: ap.attention_exp_probe(q, k, v, km, exp_bf16, block_q=bq, block_k=bk),
            lambda: ap._ref_exp_probe(q, k, v, km, exp_bf16, block_k=bk),
            {"exp_bf16": exp_bf16, "mask": mask, "blocks": [bq, bk], **tag}, timing,
            (lambda: ap._ref_exp_probe(q, k, v, km, not exp_bf16, block_k=bk)) if dtype_check else None)

    for B, H, L in ((8, 8, 2048), (4, 8, 3584)):
        # ---- timed, on the scripts' inputs
        q = randn(B, H, L, 0.9)
        flops, exps, nbytes = 4.0 * B * H * L * L * 64, float(B * H * L * L), 4 * B * H * L * 64 * 2
        # special-function instructions: one ex2.approx.ftz.bf16x2 per two exps
        sfu_ops = {"matmuls_only": 0.0, "no_max": exps / 2, "full": exps / 2, "fp32_exp": exps}
        tag = {"inputs": "q=k=v, x0.9"}
        for mode in ap.MODES:
            if mode == "matmuls_only":
                def library():
                    return torch.matmul(torch.matmul(q, q.transpose(-1, -2)), q)
            else:
                def library():
                    return torch.nn.functional.scaled_dot_product_attention(q, q, q, scale=fa.LN2)
            variant(q, q, q, mode, tag, timing=(library, flops, sfu_ops[mode], nbytes))
        for mask in ("ones", "ragged"):
            km = torch.ones((B, L), device=dev) if mask == "ones" else ragged(B, L)
            amask = (km > 0)[:, None, None, :]
            for exp_bf16 in (True, False):
                exp_probe(q, q, q, km, exp_bf16, mask, tag, timing=(
                    lambda: torch.nn.functional.scaled_dot_product_attention(q, q, q, attn_mask=amask,
                                                                             scale=fa.LN2),
                    flops, sfu_ops["full" if exp_bf16 else "fp32_exp"], nbytes + B * L * 4))
        del q
        if L != 2048:
            continue
        # ---- untimed, independent q, k, v
        km = ragged(B, L)
        for scale, modes in ((0.5, ap.MODES), (2.0, ("full", "fp32_exp"))):
            q, k, v = randn(B, H, L, scale), randn(B, H, L, scale), randn(B, H, L, 1.0)
            tag = {"inputs": f"independent, logit std ~{64 ** 0.5 * scale * scale:.0f}"}
            for mode in modes:
                variant(q, k, v, mode, tag, dtype_check=True)
            for exp_bf16 in (True, False):
                exp_probe(q, k, v, km, exp_bf16, "ragged", tag, dtype_check=True)
        default = (fa.fwd_tile_rows(B, H, L, sms), 64)
        for bq, bk in (t for t in ap.TILES if t != default):  # large logits, the other tile shapes
            variant(q, k, v, "full", tag, bq, bk, dtype_check=True)
            exp_probe(q, k, v, km, True, "ragged", tag, bq, bk, dtype_check=True)
        del q, k, v
        torch.cuda.empty_cache()

    bad = [c for c in cases if not c["ok"]]
    if bad:
        fail(f"{len(bad)} probe case(s) disagree with the plain version: "
             + "; ".join(f"{c['kernel']}/{c.get('mode', c.get('exp_bf16'))}/L={c['L']}/{c['blocks']}/"
                         f"{c.get('inputs')} rel={c['max_rel_err']:.3g} {c.get('exp_dtype_check', '')}"
                         for c in bad))
    return cases


def probes_phase(reps):
    """The two ported measuring scripts' own sweeps, once each, in the counted
    window: their lines go to stdout; every configuration must have launched
    (a configuration the scripts skip would leave the counts short)."""
    from superresolutionhep_tpu_torch.ops import kernels
    from superresolutionhep_tpu_torch.scripts import kernel_experiments, probe_exp_dtype

    kernels.reset_launches()
    t0 = time.time()
    kernel_experiments.sweep("cuda", reps=reps)
    probe_exp_dtype.sweep("cuda")
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    # per configuration: 2 warm-up calls + the 8 captured (kernel_experiments:
    # the four modes on the default tile, full on the other tiles); 2 warm-up
    # chains + 1 captured chain of REPS (probe_exp_dtype: 3 shapes and dtypes
    # on every tile)
    from superresolutionhep_tpu_torch.ops.attention_probes import MODES, TILES

    expect = dict({k: 0 for k in kernels.LAUNCHES}, probe_variant=(len(MODES) + len(TILES) - 1) * 10,
                  probe_exp_dtype=3 * len(TILES) * 3 * probe_exp_dtype.REPS)
    line = {"phase": "probes", "seconds": round(time.time() - t0, 2), "launches": counts,
            "launches_expected": expect, "ok": counts == expect}
    emit(line)
    if not line["ok"]:
        fail("probes: the scripts' sweeps did not launch every configuration")
    return counts


# ---------------------------------------------------------------------------
# phases: stage 2 (particle flow)
# ---------------------------------------------------------------------------


def sr_predicted_trees(n=32, seed=31):
    """Stage-1 output trees of ``n`` synthetic multi-particle events, in
    memory: ``SRInference.predict`` at the full width of the multipart model
    (random Xavier weights, bf16, robust attention, 3-point grid, 2 members)
    with ``store_energy_incidence`` and ``max_particles: 4``, the branches
    stage 2 reads."""
    import copy

    from superresolutionhep_tpu_torch.configs import MULTIPART_CONFIG_MV, serve_inference_config
    from superresolutionhep_tpu_torch.inference.sr import SRInference
    from superresolutionhep_tpu_torch.tools.convert import init_params_jax_layout, params_from_jax

    cfg_mv = copy.deepcopy(MULTIPART_CONFIG_MV)
    ds = multipart_dataset(cfg_mv, n, seed, make_low=True, make_particles=True, max_particles=4, window_lr_cells=2)
    params = params_from_jax(init_params_jax_layout(cfg_mv["flow_model"], seed=0), cfg_mv["flow_model"])
    inf = SRInference(serve_inference_config(cfg_mv, n_steps=3, fast_softmax=False), params=params, device="cuda")
    return inf.predict(ds, {"n_ensemble": 2, "ode_method": "ab2e", "seed": 0, "batch_size": 8,
                            "store_energy_incidence": True, "max_particles": 4})


def pf_inference_phase(trees):
    """``PFInference.predict`` of the published stage-2 model (h 64, encoder
    3 DiT layers of 4 heads of 16, kinematics 4 cross-attention layers,
    random Xavier weights from a seed), fp32, batch 32, bucket quantum 128, on
    the SR-predicted events at high and at low resolution, in the counted
    window: exactly 3 K1 per batch (the encoder's self-attention; the
    kinematics cross-attention with 4 queries is dense by design; at h 64 the
    fused prologue is its unfused equivalent, so no K3/K4).  Then every batch
    again through the same model on the dense attention path: fp32 outputs
    within 2e-4 of their max, cardinalities and assignments equal."""
    from superresolutionhep_tpu_torch.configs import PF_CONFIG_MV, PF_CONFIG_T
    from superresolutionhep_tpu_torch.data.bucketing import BucketBatcher
    from superresolutionhep_tpu_torch.data.pf_dataset import PflowEvents, collate_pf
    from superresolutionhep_tpu_torch.inference.pf import PFInference, pf_batch_to_device
    from superresolutionhep_tpu_torch.losses.set2set import set_to_set_incidence_loss
    from superresolutionhep_tpu_torch.models.pf import SAPF
    from superresolutionhep_tpu_torch.ops import kernels
    from superresolutionhep_tpu_torch.tools.convert import init_pf_params_jax_layout, pf_params_from_jax

    pf_cfg = PF_CONFIG_MV["pf_model"]
    n_enc = int(pf_cfg["encoder"]["transformer"]["num_transformer_layers"])
    params = pf_params_from_jax(init_pf_params_jax_layout(pf_cfg, seed=0), pf_cfg)

    infs = {res: PFInference({"model": {"config_mv": PF_CONFIG_MV, "config_t": dict(PF_CONFIG_T, resolution=res),
                                        "checkpoint_path": None}, "batch_size": 32}, params=params, device="cuda")
            for res in ("high", "low")}
    dss = {res: PflowEvents.from_trees(trees, PF_CONFIG_MV, energy_threshold=float(PF_CONFIG_T["energy_threshold"]),
                                       res=res, load_incidence=True) for res in infs}
    n_batches = {res: len(BucketBatcher(ds.cell_count, quantum=128, max_batch_size=32, shuffle=False))
                 for res, ds in dss.items()}

    # ---- the counted window: every count to 0 just before, read just after
    kernels.reset_launches()
    t0 = time.time()
    out = {res: infs[res].predict(dss[res], {"store_inc_wt": True}) for res in ("high", "low")}
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    predict_s = time.time() - t0
    # ---- end of the counted window
    expect = dict({k: 0 for k in kernels.LAUNCHES}, flash_fwd=n_enc * sum(n_batches.values()))
    checks = {"launch_counts": counts == expect}
    checks["one_row_per_event"] = all(len(o["Particle_Tree"]["pred_card"]) == len(dss[r]) for r, o in out.items())
    checks["predictions_finite"] = all(bool(np.isfinite(o["Particle_Tree"][k].flat).all()) for o in out.values()
                                       for k in ("pred_pt_raw", "pred_eta_raw", "pred_phi", "pred_e_raw"))

    # ---- the K1 path against the dense path, same weights, every batch (high res)
    dense = SAPF(pf_cfg, infs["high"].transforms, inference=True, attn_impl="einsum")
    dense.load_reference_state_dict(params)
    dense.to("cuda").eval()
    worst = {"logits": 0.0, "kin": 0.0, "inc": 0.0}
    same_card = same_assign = True
    ds = dss["high"]
    for idxs, bucket in BucketBatcher(ds.cell_count, quantum=128, max_batch_size=32, shuffle=False):
        batch = pf_batch_to_device(collate_pf([ds.get_event(i) if i >= 0 else None for i in idxs], bucket.pad_n, 4),
                                   torch.device("cuda"))
        with torch.no_grad():
            res = [m(batch) for m in (infs["high"].model, dense)]
        for name, a, b in zip(("logits", "kin", "inc"), res[0], res[1]):
            worst[name] = max(worst[name], float((a - b).abs().max() / b.abs().max().clamp_min(1e-30)))
        same_card = same_card and torch.equal(res[0][0].argmax(-1), res[1][0].argmax(-1))
        assigns = [set_to_set_incidence_loss(r[2], batch, r[1])[2] for r in res]
        same_assign = same_assign and torch.equal(*assigns)
    checks["flash_vs_dense_fp32"] = max(worst.values()) <= 2e-4
    checks["cardinalities_equal"] = bool(same_card)
    checks["assignments_equal"] = bool(same_assign)
    line = {"phase": "pf_inference", "events": {r: len(d) for r, d in dss.items()},
            "cells": {r: [min(d.cell_count), max(d.cell_count)] for r, d in dss.items()},
            "batches": n_batches, "predict_s": round(predict_s, 3), "launches": counts, "launches_expected": expect,
            "flash_vs_dense_max_rel_err": worst, "tol_rel": 2e-4,
            "pred_card_histogram": {r: np.bincount(o["Particle_Tree"]["pred_card"], minlength=5).tolist()
                                    for r, o in out.items()},
            "checks": checks, "ok": all(checks.values())}
    emit(line)
    if not line["ok"]:
        fail("pf inference checks failed: " + ", ".join(k for k, v in checks.items() if not v))
    return counts


# ---------------------------------------------------------------------------
# phase: trained (the shipped checkpoints, their frozen goldens)
# ---------------------------------------------------------------------------

GOLDEN_TOL = 2e-3  # tests/test_golden_sr_trained.py: samples within rtol = atol = 2e-3
GOLDEN_SIGMOID_TOL = 5e-4  # ... and the sigmoid (HR share of the proxy energy) within 5e-4
PRODUCTION_TOL = 3e-2  # scripts/make_tpu_golden.py: bf16 production path, max |diff| in sample space
# the no-max fused bf16 sampler on closure_sr against sr_tpu_golden, the 99th
# percentile of |diff| over valid cells: 0.034 on an H100, 0.036 with the
# port's plain versions and 0.050 with the JAX package's kernels in interpret
# mode on the CPU (``tests/test_torch_port_trained.py gaps``); 0.125 with the
# planted fault below.  The limit sits at twice the port's sound readings, and
# the phase's control run with the fault has to exceed it
NOMAX_GOLDEN_P99_LIMIT = 0.07
# LaunchChecker's bound on the mean |kernel - plain| of a launch, relative to
# the plain output's mean |.|: one rounding unit of the dtype (on an H100 the
# Normformer model's bf16 K1 launches read at most 3.9e-5, and 7.9e-3 with the
# planted fault below)
MEAN_TOL = {torch.bfloat16: 2.0 ** -8, torch.float32: 2.0 ** -16}
# LaunchChecker: an fp32 forward launch that misses TOL against the plain
# version is evaluated in fp64; where the plain version itself is farther
# than TOL from fp64 (ill-conditioned), the kernel may be at most this many
# times farther from fp64 than the plain version is (two fp32 summation
# orders of errors of one size; the first development call of the closure
# phase on an H100 read at most 1.79 over closure_sr's 96 layer-4 launches,
# the kernel's worst 1.13e-2 against the plain version's 1.30e-2)
EXACT_RATIO = 2.0
# the planted fault of the controls: the masked attention kernels skip the
# keys of each row's last 64-key tile that holds a valid key
FAULT_TILE = 64


class LaunchChecker:
    """Inside the window every launch of K1/K2 (masked form), K3 and K4 is
    held against the kernel's plain version on the same inputs, on the card,
    by two numbers of |kernel - plain| over the launch's output: its max
    relative to the plain output's max (bound: the kernel's ``TOL``) and its
    mean relative to the plain output's mean |.| (bound: ``MEAN_TOL``, one
    rounding unit of the dtype: rounding-order flips move few elements by one
    unit, a wrong tile moves every row that reads it).  ``worst`` keeps the
    largest of each per kernel, ``calls`` the launches seen.  On the trained
    weights this is the check a wrong kernel cannot pass: the samplers'
    outputs there are bf16-chaotic (``ROADMAP.md`` C4).  With ``fault`` the
    attention kernels run with each row's last 64-key tile masked out
    (``FAULT_TILE``) while the plain version keeps the true mask: the
    control that shows the checks catch a wrong tail tile.  With
    ``backward`` every launch of K5 and K6 (the masked form) is held too,
    against ``_ref_flash_bwd_{dq,dkv}`` on the same inputs, by its max alone
    (bound ``TOL["flash_bwd"]``, dk and dv each, as ``fp32_tile_cases``
    holds them): the rows of ds sum to 0, so keys that share an offset in a
    model multiply ds's rounding in dq (the offset-keys case there), and a
    mean bound of one rounding unit does not hold for it.  For dq, ``fp64``
    keeps the worst error of the kernel and of the plain version against an
    fp64 evaluation of the same formula (a reading).

    An fp32 launch of K1 that misses ``TOL`` against the plain version is
    evaluated in fp64 (``_fwd_fp64``, the same formula): on an
    ill-conditioned launch, where the plain version itself is farther than
    ``TOL`` from fp64, no fp32 summation order can meet ``TOL`` against
    another (``closure_sr``'s layer 4, base-2 logits to 6e5, ``ROADMAP.md``
    C4), and the launch passes its max bound when the kernel lies no farther
    from fp64 than ``EXACT_RATIO`` times the plain version does.  The mean
    bound stays.  Launches that meet ``TOL`` are not evaluated in fp64.
    ``records`` keeps every held launch's numbers and verdict.  With
    ``first`` only the window's first ``first`` forward launches are held
    (the rest run unchecked)."""

    def __init__(self, fault=False, backward=False, first=None):
        self.fault, self.backward, self.first = fault, backward, first
        self.worst, self.calls, self.dtypes, self.fp64, self.failed = {}, {}, {}, {}, {}
        self.records = []

    def _note(self, name, out, ref, fp64=None):
        """One launch: the max and mean of |kernel - plain|, relative, and its
        verdict; ``fp64()`` gives the launch's fp64 evaluation, asked for only
        when the max misses ``TOL``."""
        ref, d = ref.float(), (out.float() - ref.float()).abs()
        errs = (float(d.max() / ref.abs().max().clamp_min(1e-30)), float(d.mean() / ref.abs().mean().clamp_min(1e-30)))
        if not bool(torch.isfinite(out.float()).all()):
            errs = (float("inf"), float("inf"))
        self.dtypes[name] = out.dtype
        tol, mean_tol = self._tols(name)
        rec = {"kernel": name, "max_rel_err": errs[0], "mean_rel_err": errs[1]}
        max_ok = errs[0] <= tol
        if not max_ok and fp64 is not None:
            exact = fp64()
            top = exact.abs().max().clamp_min(1e-300)
            kernel, plain = (float((t.double() - exact).abs().max() / top) for t in (out, ref))
            rec.update(kernel_vs_fp64=kernel, plain_vs_fp64=plain, ill_conditioned=plain > tol)
            max_ok = plain > tol and kernel <= EXACT_RATIO * plain
            ratio = kernel / plain if plain > tol else 0.0  # over the ill-conditioned launches
            old = self.fp64.get(name, (0.0, 0.0, 0.0))
            self.fp64[name] = (max(old[0], kernel), max(old[1], plain), max(old[2], ratio))
        rec["passed"] = max_ok and (mean_tol is None or errs[1] <= mean_tol)
        self.records.append(rec)
        old = self.worst.get(name, (0.0, 0.0))
        self.worst[name] = (max(old[0], errs[0]), max(old[1], errs[1]))
        self.calls[name] = self.calls.get(name, 0) + 1
        self.failed[name] = self.failed.get(name, 0) + int(not rec["passed"])

    def _tols(self, name):
        if name.startswith("flash_bwd"):
            return TOL[("flash_bwd", self.dtypes[name])], None
        kind = "flash" if name.startswith("flash") else "fused"
        return TOL[(kind, self.dtypes[name])], MEAN_TOL[self.dtypes[name]]

    def ok(self):
        """Launches were seen, every one within its bounds."""
        return bool(self.worst) and not any(self.failed.values())

    def caught(self):
        """Launches were seen, and some launch outside its bounds."""
        return bool(self.worst) and any(self.failed.values())

    def tally(self, name):
        """Of ``name``'s held launches: how many, how many failed, and how
        many of each were ill-conditioned."""
        recs = [r for r in self.records if r["kernel"] == name]
        ill = [r for r in recs if r.get("ill_conditioned")]
        return {"launches": len(recs), "failed": sum(not r["passed"] for r in recs),
                "ill_conditioned": len(ill), "ill_failed": sum(not r["passed"] for r in ill)}

    def summary(self):
        out = {n: {"launches": self.calls[n], "failed_launches": self.failed[n], "max_rel_err": self.worst[n][0],
                   "mean_rel_err": self.worst[n][1], "tol_max_rel": self._tols(n)[0], "tol_mean_rel": self._tols(n)[1]}
               for n in sorted(self.worst)}
        for n, (kernel, plain, *ratio) in self.fp64.items():
            out[n].update(kernel_vs_fp64=kernel, plain_vs_fp64=plain)
            if ratio:
                out[n].update(max_kernel_over_plain_vs_fp64=ratio[0], exact_ratio=EXACT_RATIO,
                              ill_conditioned_launches=self.tally(n)["ill_conditioned"])
        return out

    def __enter__(self):
        from superresolutionhep_tpu_torch.ops import flash_attention as fa
        from superresolutionhep_tpu_torch.ops import fused_mlp as fm
        from superresolutionhep_tpu_torch.ops import fused_qkv as fq

        self._saved = [(fa, "_flash_fwd_cuda", fa._flash_fwd_cuda), (fq, "_cuda_ln_mod_proj", fq._cuda_ln_mod_proj),
                       (fm, "_cuda_dit_mlp", fm._cuda_dit_mlp)]
        flash, qkv, mlp = (fn for _, _, fn in self._saved)

        def flash_checked(q_pre, k, v, qm, km, nomax, with_lse, block_q=None):
            name = "flash_fwd_nomax" if nomax else "flash_fwd"
            if self.first is not None and self.calls.get(name, 0) >= self.first:
                return flash(q_pre, k, v, qm, km, nomax=nomax, with_lse=with_lse, block_q=block_q)
            km_run = km
            if self.fault:
                n = km.sum(1, keepdim=True)
                tail = torch.div(n - 1, FAULT_TILE, rounding_mode="floor") * FAULT_TILE
                km_run = km * (torch.arange(km.shape[1], device=km.device)[None] < tail).to(km.dtype)
            out, lse = flash(q_pre, k, v, qm, km_run, nomax=nomax, with_lse=with_lse, block_q=block_q)
            ref = fa._ref_attention_base2(*fa._heads_first(q_pre, k, v), qm[:, None], km[:, None],
                                          "nomax_clip" if nomax else "max").permute(0, 2, 1, 3)
            fp32 = not nomax and out.dtype == torch.float32
            self._note(name, out, ref, (lambda: _fwd_fp64(q_pre, k, v, qm, km)) if fp32 else None)
            return out, lse

        def qkv_checked(x, a, b, w, bias, segment_ids=None):
            out = qkv(x, a, b, w, bias, segment_ids)
            self._note("fused_qkv", out, fq._ref_ln_mod_proj_rows(x, a, b, w, bias, segment_ids))
            return out

        def mlp_checked(*args):
            out = mlp(*args)
            self._note("fused_mlp", out, fm._ref_dit_mlp_rows(*args))
            return out

        fa._flash_fwd_cuda, fq._cuda_ln_mod_proj, fm._cuda_dit_mlp = flash_checked, qkv_checked, mlp_checked
        if self.backward:
            self._saved += [(fa, "_flash_bwd_dq_cuda", fa._flash_bwd_dq_cuda),
                            (fa, "_flash_bwd_dkv_cuda", fa._flash_bwd_dkv_cuda)]
            dq_fn, dkv_fn = fa._flash_bwd_dq_cuda, fa._flash_bwd_dkv_cuda

            def plain_args(q_pre, k, v, g, lse, dl, km):
                return (*fa._heads_first(q_pre, k, v, g), lse, dl, km[:, None])

            def dq_fp64(q_pre, k, v, g, lse, dl, km):  # _ref_flash_bwd_dq's formula in fp64
                q_pre, k, v, g = (t.double() for t in fa._heads_first(q_pre, k, v, g))
                kmf = km[:, None, None, :].double()
                s = torch.matmul(q_pre, k.transpose(-1, -2)) + (kmf - 1.0) * fa.BIG
                p = torch.exp2(torch.clamp_max(s - lse.double()[..., None], 0.0)) * kmf
                ds = p * (torch.matmul(g, v.transpose(-1, -2)) - dl.double()[..., None])
                return torch.matmul(ds, k).permute(0, 2, 1, 3)

            def dq_checked(q_pre, k, v, g, lse, dl, qm, km, block_rows=None):
                dq = dq_fn(q_pre, k, v, g, lse, dl, qm, km, block_rows=block_rows)
                ref = fa._ref_flash_bwd_dq(*plain_args(q_pre, k, v, g, lse, dl, km)).permute(0, 2, 1, 3)
                self._note("flash_bwd_dq", dq, ref)
                exact = dq_fp64(q_pre, k, v, g, lse, dl, km)
                top = exact.abs().max().clamp_min(1e-300)
                errs = [float((t.double() - exact).abs().max() / top) for t in (dq, ref)]
                old = self.fp64.get("flash_bwd_dq", (0.0, 0.0))
                self.fp64["flash_bwd_dq"] = (max(old[0], errs[0]), max(old[1], errs[1]))
                return dq

            def dkv_checked(q_pre, k, v, g, lse, dl, qm, km, block_rows=None):
                dk, dv = dkv_fn(q_pre, k, v, g, lse, dl, qm, km, block_rows=block_rows)
                ref_dk, ref_dv = fa._ref_flash_bwd_dkv(*plain_args(q_pre, k, v, g, lse, dl, km))
                self._note("flash_bwd_dk", dk, ref_dk.permute(0, 2, 1, 3))
                self._note("flash_bwd_dv", dv, ref_dv.permute(0, 2, 1, 3))
                return dk, dv

            fa._flash_bwd_dq_cuda, fa._flash_bwd_dkv_cuda = dq_checked, dkv_checked
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        return False


def _fwd_fp64(q_pre, k, v, qm, km, rows=16):
    """The forward's formula (base-2 logits of pre-scaled q, padded keys
    out, running max, exp2, P V, the sum divided out, padded queries 0) in
    fp64 on (B, L, H, D) operands, ``rows`` batch rows at a time."""
    from superresolutionhep_tpu_torch.ops import flash_attention as fa

    outs = []
    for r0 in range(0, q_pre.shape[0], rows):
        sl = slice(r0, r0 + rows)
        q, kk, vv = (t.double() for t in fa._heads_first(q_pre[sl], k[sl], v[sl]))
        kmf = km[sl][:, None, None, :].double()
        s = torch.matmul(q, kk.transpose(-1, -2)) + (kmf - 1.0) * fa.BIG
        p = torch.exp2(s - s.amax(-1, keepdim=True)) * kmf
        o = torch.matmul(p, vv) / p.sum(-1, keepdim=True).clamp_min(1e-300)
        outs.append((o * (qm[sl][:, None, :, None] > 0).double()).permute(0, 2, 1, 3))
        del q, kk, vv, s, p, o
    return torch.cat(outs)


def _sha256(path):
    import hashlib

    with open(path, "rb") as fp:
        return hashlib.sha256(fp.read()).digest()


def _golden_inputs(name, x0s):
    """A frozen SR golden's batch on the card, its expected samples, its
    valid mask and the fixture's x0 (the JAX sampler's draw); the golden's
    bytes must be those the fixture was made from."""
    path = os.path.join(ROOT, "tests", "golden", f"{name}.npz")
    if _sha256(path) != bytes(x0s[f"golden_sha256::{name}"]):
        fail(f"trained: {path} is not the file the x0 fixture was made from")
    z = np.load(path)
    batch = {k: torch.from_numpy(z[f"batch::{k}"]).cuda() for k in
             ("eta", "cosphi", "sinphi", "layer", "e_proxy", "q_mask")}
    x0 = torch.from_numpy(x0s[f"x0::{name}"]).cuda()
    return z, batch, x0, z["batch::q_mask"].astype(bool)


class GoldenEvents:
    """A frozen SR golden's batch as an in-memory dataset for
    ``SRInference.predict``: one event a row, its valid cells, its
    per-event statistics.  The golden holds no low-resolution cells and no
    particles, so those output trees come out empty."""

    def __init__(self, z):
        from superresolutionhep_tpu_torch.data.sr_dataset import HIGH_KEYS_F32, SupResEvent

        self.cell_count_high = z["batch::q_mask"].astype(bool).sum(1)
        empty = np.zeros(0, np.float32)
        self.events = []
        for i, n in enumerate(self.cell_count_high):
            high = {k: z[f"batch::{k}"][i, :n, 0] for k in HIGH_KEYS_F32 + ["layer"]}
            self.events.append(SupResEvent(
                high=high, low={k: empty for k in ("eta_raw", "phi", "layer", "e_meas_raw")},
                particles={k: empty for k in ("pt", "eta", "phi", "e", "pdgid", "dep_e")},
                high_e_part=None, low_e_part=None, idx=i,
                cond_params={"mean": float(z["batch::cond_mean"][i, 0]), "std": float(z["batch::cond_std"][i, 0])}))

    def __len__(self):
        return len(self.events)

    def get_event(self, idx):
        return self.events[idx]


def trained_phase(trees, reps):
    """The shipped trained checkpoints through the port's entry points, read
    from their Flax msgpack blobs (``saved_checkpoints/closure_{sr,pf}/
    params.msgpack``, ``train/msgpack_io.py``), against their frozen goldens.
    The JAX sampler's noise comes from ``tests/golden_torch/sr_golden_x0.npz``.
    ``closure_sr`` is the multipart model at full width (h 256, 6 DiT layers,
    4 heads of 64) with 9 Fourier geometry octaves.
      * fp32 (K1's fp32 build), ``generate_samples`` at n_steps 25 on
        ``sr_trained_golden``'s (2, 640) batch; each counted window holds
        exactly 6 K1 per model evaluation and nothing else.  ``ab2`` must
        meet the golden's tolerances.  ``dopri5``'s distance to its golden
        is a reading: its adaptive steps turn a one-ulp change of the first
        step size into differences far above the tolerance on this model
        (the JAX package's own solver run op by op misses its golden so;
        ``tests/test_torch_port_trained.py gaps``);
      * bf16 production: ``SRInference.predict`` with the serving settings
        (bf16, ``fast_softmax``, fused prologue, ``ab2e``, n_steps 25) on
        ``sr_tpu_golden``'s four events.  Its first-batch gate rejects the
        no-max kernel on this checkpoint (the attention logits leave the
        clip), so it samples on the robust unfused bf16 model: exactly 6 K1
        per evaluation (24, and one for the gate) plus the gate's one
        evaluation of the fast model (6 K2, 6 K3, 6 K4); each launch held
        against its plain version (``LaunchChecker``), and a control with
        the planted fault that must fail it; finite samples.  Readings
        beside 3e-2: the distance to the port's fp32 run from the same x0
        and to the golden frozen on a TPU (bf16 is chaotic on this
        checkpoint: the JAX package's own bf16 path is 2.96 from its fp32
        one, ``ROADMAP.md`` C4); the predict call's and its sampler call's
        wall time;
      * the path the gate rejects, run for its kernels: the no-max fused
        bf16 model (24 evaluations, exactly 144 each of K2/K3/K4, held
        against their plain versions) against ``sr_tpu_golden``, which was
        frozen from that function: the 99th percentile of |diff| within
        ``NOMAX_GOLDEN_P99_LIMIT``, and the planted fault beyond it.  Its
        launches are not the main path's and stay out of the phase's total;
      * ``closure_pf``: ``PFInference`` loaded from its blob on the
        SR-predicted events at high resolution, exactly 3 K1 per batch, its
        K1 path against the dense path (fp32, 2e-4 of each output's max)."""
    from superresolutionhep_tpu_torch.configs import (CLOSURE_PF_DIR, CLOSURE_SR_CONFIG_MV, CLOSURE_SR_CONFIG_T,
                                                      CLOSURE_SR_DIR, PF_CONFIG_MV, PF_CONFIG_T,
                                                      serve_inference_config)
    from superresolutionhep_tpu_torch.data.bucketing import BucketBatcher
    from superresolutionhep_tpu_torch.data.pf_dataset import PflowEvents, collate_pf
    from superresolutionhep_tpu_torch.flow.sampling import generate_samples
    from superresolutionhep_tpu_torch.inference.pf import PFInference, pf_batch_to_device
    from superresolutionhep_tpu_torch.inference.sr import SRInference
    from superresolutionhep_tpu_torch.models.pf import SAPF
    from superresolutionhep_tpu_torch.ops import kernels

    sr_blob = os.path.join(ROOT, CLOSURE_SR_DIR, "params.msgpack")
    x0s = np.load(os.path.join(ROOT, "tests", "golden_torch", "sr_golden_x0.npz"))
    n_layers = int(CLOSURE_SR_CONFIG_MV["flow_model"]["transformer"]["num_transformer_layers"])
    zero = {k: 0 for k in kernels.LAUNCHES}
    total = dict(zero)
    checks, line = {}, {"phase": "trained", "checkpoint": CLOSURE_SR_DIR}

    t0 = time.time()
    inf32 = SRInference({"model": {"config_mv": CLOSURE_SR_CONFIG_MV, "config_t": CLOSURE_SR_CONFIG_T,
                                   "checkpoint_path": sr_blob, "n_steps": 25}}, device="cuda")
    line["load_s"] = round(time.time() - t0, 3)
    z, batch, x0, mask = _golden_inputs("sr_trained_golden", x0s)
    checks["params_are_the_goldens"] = _sha256(sr_blob) == bytes(z["params_sha256"])

    def counted(model):
        calls = [0]

        def apply(b, x, t):
            calls[0] += 1
            return model(b, x, t)
        return apply, calls

    # ---- fp32: ab2 and dopri5 against sr_trained_golden, one counted window each
    fp32 = {}
    for method in ("ab2", "dopri5"):
        apply, calls = counted(inf32.model)
        kernels.reset_launches()
        out = generate_samples(apply, batch, n_steps=int(z["n_steps"]), method=method, x0=x0)
        torch.cuda.synchronize()
        counts = dict(kernels.LAUNCHES)
        got, want = out[..., 0].float().cpu().numpy()[mask], z[f"expected::{method}"][..., 0][mask]
        excess = np.abs(got - want) - (GOLDEN_TOL + GOLDEN_TOL * np.abs(want))
        sig = np.abs(1.0 / (1.0 + np.exp(-got)) - 1.0 / (1.0 + np.exp(-want)))
        fp32[method] = {"model_calls": calls[0], "max_abs_diff": float(np.abs(got - want).max()),
                        "max_excess_over_tol": float(excess.max()), "sigmoid_max_abs_diff": float(sig.max()),
                        "launches": {k: v for k, v in counts.items() if v}}
        within = bool(excess.max() <= 0) and bool(sig.max() <= GOLDEN_SIGMOID_TOL)
        fp32[method]["within_golden_tol"] = within
        if method == "ab2":
            checks["ab2_within_golden_tol"] = within
        checks[f"{method}_finite"] = bool(np.isfinite(got).all())
        checks[f"{method}_launch_counts"] = counts == dict(zero, flash_fwd=n_layers * calls[0])
        total = {k: total[k] + counts[k] for k in total}
    line.update(fp32=fp32, golden_tol={"rtol": GOLDEN_TOL, "atol": GOLDEN_TOL, "sigmoid": GOLDEN_SIGMOID_TOL})

    # ---- bf16 production: SRInference.predict with the serving settings on
    # sr_tpu_golden's four events, the fixture's x0 through the noise hook
    ztpu, batch, x0, mask = _golden_inputs("sr_tpu_golden", x0s)
    method, n_steps = bytes(ztpu["method"]).decode(), int(ztpu["n_steps"])
    evals = n_steps - 1  # ab2e: one model evaluation per grid interval
    prod = SRInference(serve_inference_config(CLOSURE_SR_CONFIG_MV, CLOSURE_SR_CONFIG_T, checkpoint_path=sr_blob,
                                              n_steps=n_steps), device="cuda")
    events = GoldenEvents(ztpu)
    inf_dict = {"n_ensemble": 1, "ode_method": method, "batch_size": len(events), "seed": 0}
    x0_host = x0.cpu().numpy()[None]

    def noise(bi, shape):
        if bi != 0 or tuple(shape) != x0_host.shape:
            fail(f"trained: predict asked for noise {bi}, {shape}; the golden's four events make one batch")
        return x0_host

    kernels.reset_launches()
    with LaunchChecker() as chk:
        pred = prod.predict(events, inf_dict, noise=noise)
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    total = {k: total[k] + counts[k] for k in total}
    passed = bool(prod.nomax_selfcheck_passed)
    # the first-batch gate evaluates the model once on each path, then the
    # sampler runs on the path it chose
    robust, fast = (1, 1 + evals) if passed else (1 + evals, 1)
    checks["production_launch_counts"] = counts == dict(
        zero, flash_fwd=n_layers * robust, flash_fwd_nomax=n_layers * fast, fused_qkv=n_layers * fast,
        fused_mlp=n_layers * fast)
    checks["production_vs_plain"] = chk.ok()
    got = np.concatenate([pred["High_Tree"]["raw_nn_pred"][i] for i in range(len(events))])
    checks["production_finite"] = got.shape == (int(mask.sum()),) and bool(np.isfinite(got).all())
    in_use = prod.model_fast if passed else prod.model
    readings = {}
    # the same sampler on the same model called directly: predict's rows are the events' own
    direct = generate_samples(in_use, batch, n_steps=n_steps, method=method, x0=x0)[..., 0].float().cpu().numpy()
    readings["vs_direct_sampler_max_abs"] = float(np.abs(got - direct[mask]).max())
    ref32 = generate_samples(lambda b, x, t: inf32.model(b, x, t), batch, n_steps=n_steps, method=method, x0=x0)
    d32 = np.abs(got - ref32[..., 0].float().cpu().numpy()[mask])
    readings["vs_port_fp32"] = {"max_abs_diff": float(d32.max()), "p99_abs_diff": float(np.percentile(d32, 99)),
                                "within": bool(d32.max() <= PRODUCTION_TOL)}
    d_tpu = np.abs(got - ztpu["expected"][..., 0][mask])
    readings["vs_tpu_golden"] = {"max_abs_diff": float(d_tpu.max()), "p99_abs_diff": float(np.percentile(d_tpu, 99)),
                                 "within": bool(d_tpu.max() <= PRODUCTION_TOL)}
    # control: one evaluation of the path in use with the planted fault
    with torch.no_grad(), LaunchChecker(fault=True) as bad:
        in_use(batch, x0, torch.full((batch["eta"].shape[0],), 0.5, device="cuda"))
    checks["production_control_caught"] = bad.caught()

    def timed(fn):
        wall = []
        for _ in range(max(3, reps // 4)):
            torch.cuda.synchronize()
            t = time.time()
            fn()
            torch.cuda.synchronize()
            wall.append((time.time() - t) * 1e3)
        return {"median": statistics.median(wall), "all": [round(w, 2) for w in wall]}

    from superresolutionhep_tpu_torch.scripts.common import card

    line.update(production={
        "entry": "SRInference.predict", "events": len(events), "batch": list(mask.shape), "method": method,
        "n_steps": n_steps, "dtype": "bf16", "selfcheck_passed": passed,
        "path": "no-max K2, fused K3/K4" if passed else "robust K1, unfused",
        "launches": {k: v for k, v in counts.items() if v}, "vs_plain": chk.summary(),
        "control_vs_plain": bad.summary(), "readings": readings, "tol": PRODUCTION_TOL,
        "predict_call_ms": timed(lambda: prod.predict(events, inf_dict, noise=noise)),
        "sampler_call_ms": timed(lambda: generate_samples(in_use, batch, n_steps=n_steps, method=method, x0=x0)),
        "card": card()})

    # ---- the path the gate rejects on this checkpoint, run for its kernels:
    # the no-max fused bf16 model (K2/K3/K4 on trained weights) through the
    # same sampler, against sr_tpu_golden, frozen from that function on a TPU
    if prod.model_fast is None:
        fail("trained: the serving settings built no fast model")
    kernels.reset_launches()
    with LaunchChecker() as chk:
        out = generate_samples(prod.model_fast, batch, n_steps=n_steps, method=method, x0=x0)
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    per = n_layers * evals
    checks["nomax_launch_counts"] = counts == dict(zero, flash_fwd_nomax=per, fused_qkv=per, fused_mlp=per)
    checks["nomax_vs_plain"] = chk.ok()
    got = out[..., 0].float().cpu().numpy()[mask]
    d_tpu = np.abs(got - ztpu["expected"][..., 0][mask])
    with LaunchChecker(fault=True) as bad:
        out_bad = generate_samples(prod.model_fast, batch, n_steps=n_steps, method=method, x0=x0)
    d_bad = np.abs(out_bad[..., 0].float().cpu().numpy()[mask] - ztpu["expected"][..., 0][mask])
    p99, p99_bad = float(np.percentile(d_tpu, 99)), float(np.percentile(d_bad, 99))
    checks["nomax_finite"] = bool(np.isfinite(got).all())
    checks["nomax_golden_p99"] = p99 <= NOMAX_GOLDEN_P99_LIMIT
    checks["nomax_control_caught"] = bad.caught() and p99_bad > NOMAX_GOLDEN_P99_LIMIT
    line.update(gate_rejected_nomax={
        "launches": {k: v for k, v in counts.items() if v}, "vs_plain": chk.summary(),
        "control_vs_plain": bad.summary(),
        "vs_tpu_golden": {"max_abs_diff": float(d_tpu.max()), "p99_abs_diff": p99, "tol_max": PRODUCTION_TOL,
                          "limit_p99": NOMAX_GOLDEN_P99_LIMIT, "control_p99_abs_diff": p99_bad}})

    # ---- closure_pf from its blob: the K1 path against the dense path
    pf_cfg = PF_CONFIG_MV["pf_model"]
    n_enc = int(pf_cfg["encoder"]["transformer"]["num_transformer_layers"])
    pf = PFInference({"model": {"config_mv": PF_CONFIG_MV, "config_t": dict(PF_CONFIG_T, resolution="high"),
                                "checkpoint_path": os.path.join(ROOT, CLOSURE_PF_DIR, "params.msgpack")},
                      "batch_size": 32}, device="cuda")
    dense = SAPF(pf_cfg, pf.transforms, inference=True, attn_impl="einsum")
    dense.load_state_dict(pf.model.state_dict(), strict=True)
    dense.to("cuda").eval()
    ds = PflowEvents.from_trees(trees, PF_CONFIG_MV, energy_threshold=float(PF_CONFIG_T["energy_threshold"]),
                                res="high", load_incidence=True)
    worst = {"logits": 0.0, "kin": 0.0, "inc": 0.0}
    n_batches = 0
    kernels.reset_launches()
    for idxs, bucket in BucketBatcher(ds.cell_count, quantum=128, max_batch_size=32, shuffle=False):
        b = pf_batch_to_device(collate_pf([ds.get_event(i) if i >= 0 else None for i in idxs], bucket.pad_n, 4),
                               torch.device("cuda"))
        with torch.no_grad():
            res = [pf.model(b), dense(b)]
        n_batches += 1
        for name, a, r in zip(("logits", "kin", "inc"), res[0], res[1]):
            worst[name] = max(worst[name], float((a - r).abs().max() / r.abs().max().clamp_min(1e-30)))
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    total = {k: total[k] + counts[k] for k in total}
    checks["closure_pf_launch_counts"] = counts == dict(zero, flash_fwd=n_enc * n_batches)
    checks["closure_pf_flash_vs_dense"] = max(worst.values()) <= TOL[("flash", torch.float32)]
    line.update(closure_pf={"batches": n_batches, "flash_vs_dense_max_rel_err": worst,
                            "tol_rel": TOL[("flash", torch.float32)], "launches": {k: v for k, v in counts.items() if v}})
    line.update(checks=checks, ok=all(checks.values()))
    emit(line)
    if not line["ok"]:
        fail("trained checks failed: " + ", ".join(k for k, v in checks.items() if not v))
    return total


# ---------------------------------------------------------------------------
# phase: normformer (the GPT-2 + Normformer FlowModel)
# ---------------------------------------------------------------------------


def normformer_phase(seed=5):
    """The FlowModel with ``transformer.type: GPT-2+Normformer`` at the
    multipart model's width (h 256, 6 layers, 4 heads of 64), random Xavier
    weights from a seed, one evaluation on a (4, 1024) batch of synthetic
    two-particle events (~860 cells) through K1 in fp32 and bf16 and through
    the no-max K2 in bf16.  Each counted window holds exactly 6 launches of
    its kernel and nothing else, and each launch is held against the
    kernel's plain version on its own inputs (``LaunchChecker``).  fp32 is
    also held against the fp32 dense path, within 2e-4 of the output's max.
    The bf16 paths' distance to the bf16 dense path is a reading: bf16
    rounding through 6 layers of random weights moves the output by ~9% of
    its max on every path, the dense one included, and the planted tail-tile
    fault hides in it (0.099 of the max with the fault, 0.090 without, on an
    H100).
    Controls: each evaluation again with the planted fault (``FAULT_TILE``)
    must fail its checks."""
    import copy

    from superresolutionhep_tpu_torch.configs import MULTIPART_CONFIG_MV
    from superresolutionhep_tpu_torch.data.sr_dataset import MODEL_BATCH_KEYS, collate
    from superresolutionhep_tpu_torch.inference.sr import batch_to_device
    from superresolutionhep_tpu_torch.models.flow_model import FlowModel
    from superresolutionhep_tpu_torch.models.precision import cast_params_for_inference
    from superresolutionhep_tpu_torch.ops import kernels
    from superresolutionhep_tpu_torch.tools.convert import init_params_jax_layout, params_from_jax

    cfg_mv = copy.deepcopy(MULTIPART_CONFIG_MV)
    cfg = cfg_mv["flow_model"]
    cfg["transformer"]["type"] = "GPT-2+Normformer"
    n_layers = int(cfg["transformer"]["num_transformer_layers"])
    sd = params_from_jax(init_params_jax_layout(cfg, seed=seed), cfg)
    ds = multipart_dataset(cfg_mv, 4, seed, min_particles=2, max_particles=2, window_lr_cells=1)  # ~860 cells
    events = [ds.get_event(i) for i in range(len(ds))]
    pad = 1024
    batch = batch_to_device(collate(events, pad), torch.device("cuda"), MODEL_BATCH_KEYS)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(batch["e_proxy"].shape, generator=gen, device="cuda")
    t = torch.rand((len(events),), generator=gen, device="cuda")
    mask = batch["q_mask"]
    zero = {k: 0 for k in kernels.LAUNCHES}
    total = dict(zero)
    checks, results = {}, {}

    def model(impl, dtype):
        m = FlowModel(cfg, attn_impl=impl)
        m.load_reference_state_dict(sd, strict=True)
        m.to("cuda").eval().requires_grad_(False)
        return cast_params_for_inference(m, dtype) if dtype is not None else m

    def rel(a, b):
        return float((a - b)[mask].abs().max() / b[mask].abs().max().clamp_min(1e-30))

    with torch.no_grad():
        ref32 = model("einsum", None)(batch, x, t).float()
        ref16 = model("einsum", torch.bfloat16)(batch, x, t).float()
    for label, impl, dtype, kernel in (("fp32", "flash", None, "flash_fwd"),
                                       ("bf16", "flash", torch.bfloat16, "flash_fwd"),
                                       ("bf16_nomax", "flash_nomax", torch.bfloat16, "flash_fwd_nomax")):
        m = model(impl, dtype)
        kernels.reset_launches()
        with torch.no_grad(), LaunchChecker() as chk:
            out = m(batch, x, t).float()
        torch.cuda.synchronize()
        counts = dict(kernels.LAUNCHES)
        total = {k: total[k] + counts[k] for k in total}
        with torch.no_grad(), LaunchChecker(fault=True) as bad:
            out_bad = m(batch, x, t).float()
        res = {"launches": {k: v for k, v in counts.items() if v}, "vs_plain": chk.summary(),
               "control_vs_plain": bad.summary()}
        checks[f"{label}_launch_counts"] = counts == dict(zero, **{kernel: n_layers})
        checks[f"{label}_vs_plain"] = chk.ok() and bool(torch.isfinite(out[mask]).all())
        if dtype is None:
            tol = TOL[("flash", torch.float32)]
            res.update(max_rel_err_vs_fp32_dense=rel(out, ref32), tol_rel=tol,
                       control_max_rel_err_vs_fp32_dense=rel(out_bad, ref32))
            checks[f"{label}_flash_vs_einsum"] = res["max_rel_err_vs_fp32_dense"] <= tol
            checks[f"{label}_control_caught"] = bad.caught() and res["control_max_rel_err_vs_fp32_dense"] > tol
        else:
            res.update(max_rel_err_vs_bf16_dense=rel(out, ref16), max_rel_err_vs_fp32_dense=rel(out, ref32),
                       control_max_rel_err_vs_bf16_dense=rel(out_bad, ref16))
            checks[f"{label}_control_caught"] = bad.caught()
        results[label] = res
    results["bf16_dense_max_rel_err_vs_fp32_dense"] = rel(ref16, ref32)
    line = {"phase": "normformer", "batch": [len(events), pad], "cells": [len(e.high["e_proxy"]) for e in events],
            "layers": n_layers, **results, "checks": checks, "ok": all(checks.values())}
    emit(line)
    if not line["ok"]:
        fail("normformer checks failed: " + ", ".join(k for k, v in checks.items() if not v))
    return total


def budget_sized_pf_events(ds, n_cells, rng):
    """Stage-2 events of ``n_cells[i]`` cells each, for timing at realistic
    sizes: cells drawn with replacement from all the cells of ``ds`` (every
    per-cell field of one cell kept together), the particles of a random event
    of ``ds``, and incidence rows drawn from a Dirichlet over its particles."""
    evs = [ds.get_event(i) for i in range(len(ds))]
    cell_keys = [k for k, v in evs[0].items() if k.startswith("cell_")]
    pool = {k: np.concatenate([ev[k] for ev in evs]) for k in cell_keys}
    out = []
    for n in n_cells:
        src = evs[int(rng.integers(len(evs)))]
        pick = rng.integers(0, len(pool["cell_e"]), n)
        ev = {k: v for k, v in src.items() if not k.startswith("cell_")}
        ev.update({k: v[pick] for k, v in pool.items()})
        inc = np.zeros((n, src["incidence_matrix"].shape[1]), np.float32)
        n_part = min(src["n_particles"], inc.shape[1])
        inc[:, :n_part] = rng.dirichlet(np.ones(n_part), n)
        ev["incidence_matrix"] = inc
        out.append(ev)
    return out


def pf_train_phase(trees, reps):
    """``PFTrainer.fit`` of the published stage-2 model with the published
    training settings (incidence set loss, card weight 0.5, bucket quantum
    128, batch 32, the cost budget, clip 1.0, warm-start cosine), fp32, seeded
    init with its policies, on the low-resolution SR-predicted events: two
    epochs with validation and checkpoints in the counted window (exactly 3
    K1 + 3 K5 + 3 K6 per step, 3 K1 per validation batch), then resumed for
    a third.  Then one fp32 step's gradients through K1/K5/K6 against the
    dense path (1e-4 of each leaf's max, floored at 1e-3 of the largest), one
    bf16 step held by its loss (3e-2 of the fp32 loss), and the median step
    time on that batch (a few cells per event) and on batches at the
    published bucket sizes: pad 1024 and 2048 with the batch the cost budget
    allows (32 and 27 events), each event filling its bucket."""
    import copy
    import tempfile

    from superresolutionhep_tpu_torch.config import resolve_threshold
    from superresolutionhep_tpu_torch.configs import PF_CONFIG_MV, PF_CONFIG_T
    from superresolutionhep_tpu_torch.data.pf_dataset import PflowEvents, collate_pf
    from superresolutionhep_tpu_torch.inference.pf import pf_batch_to_device
    from superresolutionhep_tpu_torch.ops import kernels
    from superresolutionhep_tpu_torch.tools.convert import init_pf_params_jax_layout, pf_params_from_jax
    from superresolutionhep_tpu_torch.train.checkpoint import CheckpointManager
    from superresolutionhep_tpu_torch.train.pf_trainer import PFTrainer

    dev = torch.device("cuda")
    pf_cfg = PF_CONFIG_MV["pf_model"]
    n_enc = int(pf_cfg["encoder"]["transformer"]["num_transformer_layers"])
    cfg_t = dict(copy.deepcopy(PF_CONFIG_T), num_epochs=2, epoch_end_plots=False, num_workers=2)
    ds = PflowEvents.from_trees(trees, PF_CONFIG_MV, energy_threshold=float(cfg_t["energy_threshold"]),
                                res=cfg_t["resolution"], load_incidence=True)
    run = tempfile.mkdtemp(prefix="srhep_pf_train_")
    calls = {"train": 0, "val": 0}

    def count_calls(_module, _inputs):
        calls["train" if torch.is_grad_enabled() else "val"] += 1

    # ---- the counted window: fit, every count to 0 just before, read just after
    tr = PFTrainer(PF_CONFIG_MV, cfg_t, run_dir=run, seed=0, device="cuda")
    hook = tr.model.register_forward_pre_hook(count_calls)
    kernels.reset_launches()
    t0 = time.time()
    tr.fit(ds, ds)
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    fit_s = time.time() - t0
    # ---- end of the counted window
    hook.remove()
    expect = dict({k: 0 for k in kernels.LAUNCHES}, flash_fwd=n_enc * (calls["train"] + calls["val"]),
                  flash_bwd_dq=n_enc * calls["train"], flash_bwd_dkv=n_enc * calls["train"])
    lines = [json.loads(x) for x in open(f"{run}/metrics.jsonl")]
    checks = {"fit_epochs": tr.epoch == 2 and len(lines) == 2 and calls["train"] == tr.global_step > 0,
              "launch_counts": counts == expect,
              "losses_finite": all(np.isfinite(x["train/loss"]) and np.isfinite(x["val_loss_to_optimize_on"])
                                   for x in lines)}
    final = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
    restored = CheckpointManager(f"{run}/checkpoints").restore(which="last", map_location=dev)["params"]
    tr2 = PFTrainer(PF_CONFIG_MV, dict(cfg_t, num_epochs=3), run_dir=run, seed=1, device="cuda")
    tr2.fit(ds, ds, resume=True)
    checks["resume_restored_last_epoch"] = (all(torch.equal(restored[k], final[k]) for k in final)
                                            and tr2.epoch == 3 and tr2.opt.count == tr.opt.count + tr2.global_step)
    line = {"phase": "pf_train", "run_dir": run, "n_events": len(ds), "cells": [min(ds.cell_count),
                                                                              max(ds.cell_count)],
            "fit_s": round(fit_s, 2), "train_steps": tr.global_step, "model_calls": dict(calls),
            "launches": counts, "launches_expected": expect,
            "epochs": [{k: x.get(k) for k in ("step", "lr", "train/loss", "train/card_loss", "train/inc_loss",
                                              "train/grad_norm", "train/epoch_s", "val_loss_to_optimize_on",
                                              "val/card_accuracy")} for x in lines]}
    idxs, bucket = next(iter(tr._batcher(ds, "train", seed=0)))  # the first training batch of epoch 0
    del tr, tr2

    # ---- one step on that batch: K1/K5/K6 against the dense path, fp32; bf16 by its loss
    hb = collate_pf([ds.get_event(i) if i >= 0 else None for i in idxs], bucket.pad_n, 4)
    batch = pf_batch_to_device(hb, dev)
    params = pf_params_from_jax(init_pf_params_jax_layout(pf_cfg, seed=3), pf_cfg)  # Xavier adaLN: gates open
    res = {}
    for name, impl, dtype in (("flash", "auto", None), ("dense", "einsum", None), ("bf16", "auto", torch.bfloat16)):
        trx = PFTrainer(PF_CONFIG_MV, cfg_t, run_dir=tempfile.mkdtemp(), device="cuda", params=params,
                        attn_impl=impl, dtype=dtype)
        before = dict(kernels.LAUNCHES)
        loss, _, g = trx.loss_and_grads(batch)
        torch.cuda.synchronize()
        res[name] = ({n: gi for (n, _), gi in zip(trx.model.named_parameters(), g)}, float(loss.detach()),
                     {k: kernels.LAUNCHES[k] - before[k] for k in kernels.LAUNCHES if kernels.LAUNCHES[k] != before[k]})
        del trx
    ok, worst, leaf = _grads_agree(res["flash"][0], res["dense"][0], 1e-4)
    lf, ld, lb = res["flash"][1], res["dense"][1], res["bf16"][1]
    kernels_step = {"flash_fwd": n_enc, "flash_bwd_dq": n_enc, "flash_bwd_dkv": n_enc}
    checks["flash_vs_dense_grads_fp32"] = (ok and abs(lf - ld) <= 1e-4 * abs(ld) and res["flash"][2] == kernels_step
                                           and res["dense"][2] == {})
    checks["bf16_step_loss"] = abs(lb - lf) <= 3e-2 * abs(lf) and res["bf16"][2] == kernels_step
    line["grad_check"] = {"shape": list(hb["cell_e"].shape), "tol_rel": 1e-4, "worst_rel_err": worst, "leaf": leaf,
                          "loss": {"flash": lf, "dense": ld, "bf16": lb}, "bf16_loss_tol_rel": 3e-2,
                          "launches": {k: v[2] for k, v in res.items()}}

    # ---- step times (a reading, not a benchmark): that batch, then batches at
    # the published bucket sizes
    trs = PFTrainer(PF_CONFIG_MV, dict(cfg_t, lr_scheduler=None), run_dir=tempfile.mkdtemp(), device="cuda",
                    params=params)

    def step_times(hbx):
        bx = pf_batch_to_device(hbx, dev)
        for _ in range(2):
            trs.train_step(bx, lr=1e-3)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = []
        for _ in range(max(5, reps // 4)):
            t1 = time.time()
            st = trs.train_step(bx, lr=1e-3)
            float(st["loss"])
            ms.append((time.time() - t1) * 1e3)
        return {"B": int(hbx["cell_e"].shape[0]), "N": int(hbx["cell_e"].shape[1]),
                "valid_cells": int(hbx["cell_mask"].sum()), "median_ms": statistics.median(ms), "min_ms": min(ms),
                "max_ms": max(ms), "n": len(ms), "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                "profile": profile_steps(lambda: trs.train_step(bx, lr=1e-3), 3)}

    line["train_step_ms"] = step_times(hb)
    budget = resolve_threshold(cfg_t["n_sq_sum_threshold_train"])
    rng = np.random.default_rng(5)
    line["train_step_ms_budget"] = []
    for pad_n in (1024, 2048):
        bsz = min(int(cfg_t["batch_size_train"]), budget // (pad_n * pad_n))
        evs = budget_sized_pf_events(ds, [pad_n - int(x) for x in rng.integers(0, 128, bsz)], rng)
        line["train_step_ms_budget"].append(dict(step_times(collate_pf(evs, pad_n, 4)),
                                                 cost=bsz * pad_n * pad_n, cost_budget=budget))
    del trs
    line["checks"], line["ok"] = checks, all(checks.values())
    emit(line)
    if not line["ok"]:
        fail("pf train checks failed: " + ", ".join(k for k, v in checks.items() if not v))
    return counts


# ---------------------------------------------------------------------------
# phase: parallel (data, sequence and tensor parallelism on torch.distributed)
# ---------------------------------------------------------------------------

# two ranks against one, fp32, relative to each output's max: the same
# arithmetic with the shards' partial sums added in another order
PARALLEL_TOL = 1e-5
# gradients, relative to each leaf's max (floored at 1e-3 of the largest
# leaf).  The multipart model's LeakyReLUs have a kink at 0: where a
# pre-activation lies within rounding of 0, another summation order of the
# forward (TP's split sums, SP's gathered keys) takes the other slope (1
# against 0.01) for that cell, and the gradients move by up to 3.1e-4 of a
# leaf's max, 1.2e-5 for the median leaf, at tp = 2 on the H100 (on the CPU,
# one rank's fp32 against fp64: 2.9e-4).  So the multipart model's gradients
# are held to PARALLEL_GRAD_TOL, and the same weights with SiLU in the DiT MLP
# and the v_t head (``smooth_config``; on the CPU every path then agrees with
# fp64 within 2e-6) to PARALLEL_TOL, every leaf
PARALLEL_GRAD_TOL = 2e-3
PARALLEL_TIMEOUT_S = 300
PARALLEL_LR = 1e-3


def parallel_sr_setup():
    """The multipart model's config, its parameters (seed 3, Xavier adaLN:
    attention not gated off) in ``state_dict`` names, and a global (8, 2048)
    fp32 host batch of random features whose rows hold 2048 ... 300 valid
    cells: the two data shards hold 7648 and 3000 cells, and under seq = 2 a
    few rows' second half is all padding.  Also the flow times and noise of
    one step."""
    import copy

    from superresolutionhep_tpu_torch.configs import MULTIPART_CONFIG_MV
    from superresolutionhep_tpu_torch.tools.convert import init_params_jax_layout, params_from_jax

    cfg_mv = copy.deepcopy(MULTIPART_CONFIG_MV)
    fm = cfg_mv["flow_model"]
    params = {k[4:]: v for k, v in params_from_jax(init_params_jax_layout(fm, seed=3), fm).items()}
    rng = np.random.default_rng(21)
    B, N = 8, 2048
    lengths = np.array([2048, 2000, 1900, 1700, 1200, 900, 600, 300])
    phi = rng.uniform(-np.pi, np.pi, size=(B, N, 1))
    host = {
        "eta": rng.uniform(-1.5, 1.5, size=(B, N, 1)).astype(np.float32),
        "cosphi": np.cos(phi).astype(np.float32), "sinphi": np.sin(phi).astype(np.float32),
        "layer": rng.integers(0, 3, size=(B, N, 1)).astype(np.int32),
        "e_proxy": rng.normal(size=(B, N, 1)).astype(np.float32),
        "q_mask": np.arange(N)[None, :] < lengths[:, None],
        "target": rng.normal(size=(B, N, 1)).astype(np.float32),
        "t": rng.uniform(size=(B,)).astype(np.float32),
        "x0": rng.normal(size=(B, N, 1)).astype(np.float32),
    }
    return cfg_mv, params, host


def smooth_config(fm):
    """``fm`` with SiLU in place of the DiT MLP's and the v_t head's
    activations: the same parameters, no kink (see ``PARALLEL_GRAD_TOL``)."""
    import copy

    fm = copy.deepcopy(fm)
    fm["transformer"]["dense_config"].update(activation="SiLU", final_activation="SiLU")
    fm["v_t_pred"]["activation"] = "SiLU"
    return fm


def single_loss_and_grads(fm, params, host):
    """One rank, no process group: the fp32 flow-matching loss on ``host``
    with its ``t`` and ``x0``, and its gradients by parameter name."""
    from superresolutionhep_tpu_torch.flow.cfm import sample_location_and_conditional_flow
    from superresolutionhep_tpu_torch.models.flow_model import FlowModel

    model = FlowModel(fm).cuda().float().eval()
    model.load_state_dict(params)
    b = _dev_batch(host)
    _, xt, ut = sample_location_and_conditional_flow(b["target"], float(fm["sigma_min"]), t=b["t"], x0=b["x0"])
    vt = model(b, xt, b["t"])
    m = b["q_mask"][..., None].float()
    loss = ((vt - ut) ** 2 * m).sum() / m.sum().clamp_min(1.0)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return float(loss.detach()), dict(zip([n for n, _ in model.named_parameters()], grads))


def synthetic_pf_batch(B, N, P, seed):
    """A ``collate_pf``-shaped numpy batch with ragged cells and particles."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(N // 4, N + 1, size=B)
    cards = rng.integers(1, P + 1, size=B)
    cell_mask = np.arange(N)[None, :] < lens[:, None]
    part_mask = np.arange(P)[None, :] < cards[:, None]
    e_raw = rng.uniform(1.0, 50.0, size=(B, N)) * cell_mask
    eta_raw = rng.uniform(-2.5, 2.5, size=(B, N)) * cell_mask
    phi = rng.uniform(-np.pi, np.pi, size=(B, N)) * cell_mask
    inc = rng.uniform(size=(B, N, P)) * cell_mask[..., None] * part_mask[:, None, :]
    inc = inc / np.maximum(inc.sum(-1, keepdims=True), 1e-6)
    out = {"cell_e": np.sqrt(e_raw) / 4 - 0.5, "cell_eta": eta_raw / 2.988, "cell_phi": phi,
           "cell_cosphi": np.cos(phi) * cell_mask, "cell_sinphi": np.sin(phi) * cell_mask, "cell_e_raw": e_raw,
           "cell_eta_raw": eta_raw, "incidence_matrix": inc}
    out = {k: v.astype(np.float32) for k, v in out.items()}
    out.update(cell_layer=rng.integers(0, 3, size=(B, N)).astype(np.int32), cell_mask=cell_mask,
               part_mask=part_mask, cardinality=cards.astype(np.int32))
    for k in ("part_pt", "part_eta", "part_phi", "part_dep_e"):
        out[k] = (rng.normal(size=(B, P)) * part_mask).astype(np.float32)
    return out


def _fit_losses(run_dir):
    """``SRTrainer.fit`` of the multipart model, one epoch of a few steps on
    eight synthetic events, bf16 compute with remat, grad_accum_steps 2,
    grad_clip_norm 1.0, through the data-parallel code wherever a process
    group is up: each step's loss and gradient norm (fp32 values) and the
    launches of the fit."""
    import copy

    from superresolutionhep_tpu_torch.configs import MULTIPART_CONFIG_MV, MULTIPART_CONFIG_T
    from superresolutionhep_tpu_torch.ops import kernels
    from superresolutionhep_tpu_torch.train.sr_trainer import SRTrainer

    cfg_mv = copy.deepcopy(MULTIPART_CONFIG_MV)
    cfg_t = dict(copy.deepcopy(MULTIPART_CONFIG_T), n_event_displays=0, num_epochs=1, remat=True,
                 fused_prologue=False, num_workers=0, grad_accum_steps=2, grad_clip_norm=1.0, use_sampler=False,
                 batch_size_train=2, val_path=None)
    ds = multipart_dataset(cfg_mv, 8, 11, max_particles=4, window_lr_cells=2)
    tr = SRTrainer(cfg_mv, cfg_t, run_dir=run_dir, seed=0, dtype=torch.bfloat16, device="cuda")
    steps = []
    step = tr.train_step

    def keep(*args, **kw):
        stats = step(*args, **kw)
        steps.append(torch.stack([stats["loss"].float(), stats["grad_norm"].float()]))
        return stats

    tr.train_step = keep
    kernels.reset_launches()
    tr.fit(ds)
    torch.cuda.synchronize()
    counts = dict(kernels.LAUNCHES)
    return {"steps": torch.stack(steps).cpu().numpy(), "launches": counts, "group": tr.dp.group is not None}


def _pf_step(host_batch):
    """One fp32 ``PFTrainer`` step of the published stage-2 model (seeded
    init) on ``host_batch`` (this rank's rows under data parallelism): loss
    and gradient norm, and the launches."""
    import copy
    import tempfile

    from superresolutionhep_tpu_torch.configs import PF_CONFIG_MV, PF_CONFIG_T
    from superresolutionhep_tpu_torch.inference.pf import pf_batch_to_device
    from superresolutionhep_tpu_torch.ops import kernels
    from superresolutionhep_tpu_torch.train.pf_trainer import PFTrainer

    tr = PFTrainer(copy.deepcopy(PF_CONFIG_MV), dict(copy.deepcopy(PF_CONFIG_T), epoch_end_plots=False),
                   run_dir=tempfile.mkdtemp(prefix="srhep_pf_dp_"), seed=0, device="cuda")
    batch = pf_batch_to_device(tr.dp.shard(host_batch), tr.device)
    kernels.reset_launches()
    logs = tr.train_step(batch, lr=PARALLEL_LR)
    torch.cuda.synchronize()
    return {"loss": torch.stack([logs["loss"].float(), logs["grad_norm"].float()]).cpu().numpy(),
            "launches": dict(kernels.LAUNCHES)}


def _dev_batch(host, keys=None):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).cuda() for k, v in host.items()
            if keys is None or k in keys}


def _counted(fn):
    """(fn's result, the launches it made)."""
    from superresolutionhep_tpu_torch.ops import kernels

    kernels.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(kernels.LAUNCHES)


def parallel_rank_nccl(rank, world_size, pf_host):
    """Phase (a), world size 1 over NCCL: the data-parallel ``fit`` and PF
    step, and the sequence- (gather, ring) and tensor-parallel forwards at
    n = 1 on the (8, 2048) batch."""
    import tempfile

    from superresolutionhep_tpu_torch.parallel.mesh import Mesh, shard_batch
    from superresolutionhep_tpu_torch.parallel.sp import make_sp_forward
    from superresolutionhep_tpu_torch.parallel.tp import make_tp_forward

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"fit": _fit_losses(tempfile.mkdtemp(prefix="srhep_fit_dp_")), "pf": _pf_step(pf_host)}
    cfg_mv, params, host = parallel_sr_setup()
    fm = cfg_mv["flow_model"]
    params = {k: v.cuda() for k, v in params.items()}
    for name, shape, make, kw in (("sp_gather", {"data": 1, "seq": 1}, make_sp_forward, {"sp_mode": "gather"}),
                                  ("sp_ring", {"data": 1, "seq": 1}, make_sp_forward, {"sp_mode": "ring"}),
                                  ("tp", {"data": 1, "model": 1}, make_tp_forward, {})):
        mesh = Mesh(shape)
        _, fwd = make(fm, mesh, device="cuda", **kw)
        b = _dev_batch(shard_batch(host, mesh, cells=True))
        with torch.no_grad():
            out[name], out[f"{name}_launches"] = _counted(lambda: fwd(params, b, b["x0"], b["t"]))
    return out


def parallel_rank_gloo(rank, world_size):
    """Phase (b) and (c), two ranks on the one card over gloo: the probe of
    gloo's all_gather on CUDA tensors; a data-parallel ``SRTrainer`` step in
    fp32; the tensor-parallel forward and train step at tp = 2 and, where
    the probe passed, the sequence-parallel ones at seq = 2 (gather); each
    window's launches, ``LaunchChecker`` on the sharded K1 launches and its
    planted-fault control, and on every K1/K5/K6 launch of the train steps."""
    import copy
    import tempfile

    import torch.distributed as dist

    from superresolutionhep_tpu_torch.configs import MULTIPART_CONFIG_T
    from superresolutionhep_tpu_torch.data.sr_dataset import MODEL_BATCH_KEYS
    from superresolutionhep_tpu_torch.parallel.mesh import Mesh, shard_batch
    from superresolutionhep_tpu_torch.parallel.sp import make_sp_forward, make_sp_train_step
    from superresolutionhep_tpu_torch.parallel.tp import make_tp_forward, make_tp_train_step
    from superresolutionhep_tpu_torch.train.sr_trainer import SRTrainer

    torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.full((2,), float(rank), device="cuda")
    parts = [torch.empty_like(x) for _ in range(world_size)]
    try:
        dist.all_gather(parts, x)
        gather_ok = all(bool((p == r).all()) for r, p in enumerate(parts))
        gather_note = "ok" if gather_ok else "wrong values"
    except RuntimeError as e:  # the probe: its outcome decides whether SP runs, and is reported
        gather_ok, gather_note = False, str(e)[:300]
    out = {"gather_probe": {"ok": gather_ok, "note": gather_note}}

    cfg_mv, params, host = parallel_sr_setup()
    fm = cfg_mv["flow_model"]
    sigma = float(fm["sigma_min"])
    params = {k: v.cuda() for k, v in params.items()}
    meshes = {"dp": Mesh({"data": 2}), "tp": Mesh({"data": 1, "model": 2}), "sp": Mesh({"data": 1, "seq": 2})}

    # data parallelism: one SRTrainer step, each rank its four rows
    cfg_t = dict(copy.deepcopy(MULTIPART_CONFIG_T), n_event_displays=0, remat=False, fused_prologue=False)
    tr = SRTrainer(cfg_mv, cfg_t, run_dir=tempfile.mkdtemp(prefix="srhep_dp_"), seed=0, device="cuda",
                   params={f"net.{k}": v for k, v in params.items()}, mesh=meshes["dp"])
    seen = []
    step = tr.opt.step
    tr.opt.step = lambda grads, lr: (seen.append([g.detach().clone() for g in grads]), step(grads, lr))[1]
    b = _dev_batch(shard_batch(host, meshes["dp"]), MODEL_BATCH_KEYS)
    stats, out["dp_launches"] = _counted(lambda: tr.train_step(b, lr=PARALLEL_LR))
    names = [n for n, _ in tr.model.named_parameters()]
    out["dp"] = {"loss": float(stats["loss"]), "digest": [float(g.double().sum()) for g in seen[0]]}
    if rank == 0:
        out["dp"].update(grads=dict(zip(names, seen[0])), params=tr.model.state_dict())
    del tr, seen

    # tensor (and sequence) parallelism: forward under the checker, train step
    paths = [("tp", make_tp_forward, make_tp_train_step, {})]
    if gather_ok:
        paths.append(("sp", make_sp_forward, make_sp_train_step, {"sp_mode": "gather"}))
    for name, make_fwd, make_step, kw in paths:
        mesh = meshes[name]
        _, fwd = make_fwd(fm, mesh, device="cuda", **kw)
        _, step = make_step(fm, mesh, sigma, device="cuda", **kw)
        b = _dev_batch(shard_batch(host, mesh, cells=True))
        with LaunchChecker() as checker, torch.no_grad():
            y, out[f"{name}_fwd_launches"] = _counted(lambda: fwd(params, b, b["x0"], b["t"]))
        with LaunchChecker(fault=True) as control, torch.no_grad():
            fwd(params, b, b["x0"], b["t"])
        out[name] = {"fwd": y, "checker": checker.summary(), "checker_ok": checker.ok(),
                     "control_caught": control.caught()}
        del fwd
        for variant, cfg in (("", fm), ("_smooth", smooth_config(fm))):
            _, step = make_step(cfg, mesh, sigma, device="cuda", **kw)
            with LaunchChecker(backward=True) as checker:  # K1, K5, K6 at this path's shapes
                (loss, grads), out[f"{name}{variant}_step_launches"] = _counted(
                    lambda: step(params, b, b["t"], b["x0"]))
            out[name][f"step_checker{variant}"], out[name][f"step_checker_ok{variant}"] = (checker.summary(),
                                                                                          checker.ok())
            out[name][f"loss{variant}"] = float(loss)
            out[name][f"digest{variant}"] = [float(g.double().sum()) for g in grads.values()]
            if rank == 0:
                out[name][f"grads{variant}"] = grads
            del step
    return out


def _grad_errs(got, want):
    """Per leaf, max |got - want| over max(the leaf's max, 1e-3 of the
    largest leaf); ``got`` numpy arrays, ``want`` tensors."""
    want = {k: v.detach().float().cpu().numpy() for k, v in want.items()}
    top = max(float(np.abs(v).max()) for v in want.values())
    return {k: float(np.abs(np.asarray(got[k], np.float32) - v).max()) / max(float(np.abs(v).max()), 1e-3 * top, 1e-30)
            for k, v in want.items()}


def _grads_ok(errs, tol):
    """Every leaf within ``tol``; and the worst leaf's error and name, and
    the median leaf's error."""
    worst = max(errs, key=errs.get)
    return errs[worst] <= tol, errs[worst], worst, float(np.median(list(errs.values())))


def _rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def parallel_phase():
    """Data, sequence and tensor parallelism of the port on the one card, at
    the multipart model's full width (h 256, 6 DiT layers, 4 heads of 64).

    (a) World size 1 over NCCL: ``SRTrainer.fit`` (bf16, remat,
    grad_accum_steps 2, grad_clip_norm 1.0) through the data-parallel code,
    whose per-step losses must equal the same ``fit`` with no process group
    bit for bit (NCCL's all-reduce at one rank is a copy); a fp32 PF step the
    same way; ``make_sp_forward`` (gather, ring) and ``make_tp_forward`` at
    n = 1 against the single-rank forward.
    (b) Two ranks on the one card over gloo (NCCL refuses two ranks on one
    device): a data-parallel ``SRTrainer`` step in fp32 at (8, 2048) with
    shards of unequal cell counts — loss, every gradient, the parameters after
    AdamW against the single-rank step; ``make_tp_forward`` and
    ``make_tp_train_step`` at tp = 2 (K1/K5/K6 with 2 heads of 64 a rank) and,
    where gloo's all_gather takes CUDA tensors, ``make_sp_forward`` and the
    SP train step at seq = 2 (K1 with 1024 local queries against 2048 keys),
    against the single-rank forward and gradients (``PARALLEL_TOL``; the
    gradients as ``PARALLEL_GRAD_TOL`` says: every train step also runs on
    the same weights with SiLU in place of the kinked LeakyReLUs,
    ``smooth_config``, held to ``PARALLEL_TOL``).
    (c) Each rank's launches per window are exact, and ``LaunchChecker``
    holds every sharded K1 launch against its plain version, with its
    planted-fault control, and every K1/K5/K6 launch of the TP and SP train
    steps (fp32: 2 heads of 64 under TP, 1024 queries against 2048 keys
    under SP) against its plain version.  The ring at two ranks is not run here: gloo's
    send/recv take no CUDA tensors.  Times from these runs say nothing of
    NCCL across cards and are not recorded as such."""
    import tempfile

    from superresolutionhep_tpu_torch.configs import PF_CONFIG_MV
    from superresolutionhep_tpu_torch.data.sr_dataset import MODEL_BATCH_KEYS
    from superresolutionhep_tpu_torch.models.flow_model import FlowModel
    from superresolutionhep_tpu_torch.ops import kernels
    from superresolutionhep_tpu_torch.parallel.launch import run_ranks
    from superresolutionhep_tpu_torch.train.sr_trainer import SRTrainer

    t0 = time.time()
    zero = {k: 0 for k in kernels.LAUNCHES}
    checks, line = {}, {"phase": "parallel"}
    cfg_mv, params, host = parallel_sr_setup()
    fm = cfg_mv["flow_model"]
    L = int(fm["transformer"]["num_transformer_layers"])
    n_enc = int(PF_CONFIG_MV["pf_model"]["encoder"]["transformer"]["num_transformer_layers"])
    pf_host = synthetic_pf_batch(16, 384, int(PF_CONFIG_MV["pf_model"]["max_particles"]), seed=23)

    # ---- single-rank references, no process group
    ref_fit = _fit_losses(tempfile.mkdtemp(prefix="srhep_fit_"))
    ref_pf = _pf_step(pf_host)
    dev_params = {k: v.cuda() for k, v in params.items()}
    model = FlowModel(fm).cuda().float().eval()
    model.load_state_dict(dev_params)
    b = _dev_batch(host)
    with torch.no_grad():
        ref_fwd = model(b, b["x0"], b["t"]).float().cpu().numpy()
    del model, b
    ref_steps = {"": single_loss_and_grads(fm, dev_params, host),
                 "_smooth": single_loss_and_grads(smooth_config(fm), dev_params, host)}
    import copy

    from superresolutionhep_tpu_torch.configs import MULTIPART_CONFIG_T

    cfg_t = dict(copy.deepcopy(MULTIPART_CONFIG_T), n_event_displays=0, remat=False, fused_prologue=False)
    tr = SRTrainer(cfg_mv, cfg_t, run_dir=tempfile.mkdtemp(prefix="srhep_dp_ref_"), seed=0, device="cuda",
                   params={f"net.{k}": v for k, v in dev_params.items()})
    seen = []
    step = tr.opt.step
    tr.opt.step = lambda grads, lr: (seen.append([g.detach().clone() for g in grads]), step(grads, lr))[1]
    stats = tr.train_step(_dev_batch(host, MODEL_BATCH_KEYS), lr=PARALLEL_LR)
    names = [n for n, _ in tr.model.named_parameters()]
    ref_dp = {"loss": float(stats["loss"]), "grads": dict(zip(names, seen[0])), "params": tr.model.state_dict()}
    del tr, seen
    t_ref = time.time() - t0

    # ---- (a) world size 1 over NCCL
    t1 = time.time()
    (a,) = run_ranks(parallel_rank_nccl, 1, (pf_host,), backend="nccl", device="cuda", timeout_s=PARALLEL_TIMEOUT_S)
    t_a = time.time() - t1
    n_steps = len(ref_fit["steps"])
    fit_expect = dict(zero, flash_fwd=2 * L * n_steps, flash_bwd_dq=L * n_steps, flash_bwd_dkv=L * n_steps)
    pf_expect = dict(zero, flash_fwd=n_enc, flash_bwd_dq=n_enc, flash_bwd_dkv=n_enc)
    checks["a_fit_through_group"] = a["fit"]["group"] and not ref_fit["group"]
    checks["a_fit_losses_bit_equal"] = bool(np.array_equal(a["fit"]["steps"].view(np.uint32),
                                                           ref_fit["steps"].view(np.uint32)))
    checks["a_fit_launches"] = a["fit"]["launches"] == fit_expect == ref_fit["launches"]
    checks["a_pf_loss_bit_equal"] = bool(np.array_equal(a["pf"]["loss"].view(np.uint32),
                                                        ref_pf["loss"].view(np.uint32)))
    checks["a_pf_launches"] = a["pf"]["launches"] == pf_expect
    a_errs = {k: _rel_err(a[k], ref_fwd) for k in ("sp_gather", "sp_ring", "tp")}
    checks["a_forwards_n1"] = all(e <= PARALLEL_TOL for e in a_errs.values())
    checks["a_forward_launches"] = (a["sp_gather_launches"] == a["tp_launches"] == dict(zero, flash_fwd=L)
                                    and a["sp_ring_launches"] == zero)
    line["a"] = {"fit_steps": a["fit"]["steps"].tolist(), "fit_launches": a["fit"]["launches"],
                 "pf_loss_grad_norm": a["pf"]["loss"].tolist(), "forward_rel_err": a_errs, "seconds": round(t_a, 1)}

    # ---- (b), (c) two ranks on the one card over gloo
    t1 = time.time()
    ranks = run_ranks(parallel_rank_gloo, 2, (), backend="gloo", device="cuda:0", timeout_s=PARALLEL_TIMEOUT_S)
    t_b = time.time() - t1
    r0 = ranks[0]
    gather_ok = all(r["gather_probe"]["ok"] for r in ranks)
    line["gloo_cuda_all_gather"] = [r["gather_probe"] for r in ranks]
    step_expect = dict(zero, flash_fwd=L, flash_bwd_dq=L, flash_bwd_dkv=L)
    fwd_expect = dict(zero, flash_fwd=L)
    # data parallelism
    dp_grads_ok, dp_err, dp_leaf, dp_med = _grads_ok(_grad_errs(r0["dp"]["grads"], ref_dp["grads"]), PARALLEL_TOL)
    p_err = 0.0
    for k, v in ref_dp["params"].items():
        live = ref_dp["grads"][k].abs().cpu().numpy() > 1e-6 if k in ref_dp["grads"] else np.ones(v.shape, bool)
        want = v.cpu().numpy()
        p_err = max(p_err, float(np.abs(r0["dp"]["params"][k] - want)[live].max(initial=0.0))
                    / max(float(np.abs(want).max()), 1e-30))
    checks["b_dp_loss"] = all(abs(r["dp"]["loss"] - ref_dp["loss"]) <= PARALLEL_TOL * abs(ref_dp["loss"])
                              for r in ranks)
    checks["b_dp_grads"] = dp_grads_ok and ranks[1]["dp"]["digest"] == r0["dp"]["digest"]
    checks["b_dp_params_after_adamw"] = p_err <= PARALLEL_TOL
    checks["c_dp_launches"] = all(r["dp_launches"] == step_expect for r in ranks)
    line["b_dp"] = {"loss": [r["dp"]["loss"] for r in ranks], "ref_loss": ref_dp["loss"],
                    "worst_grad_rel_err": dp_err, "leaf": dp_leaf, "median_grad_rel_err": dp_med,
                    "params_rel_err": p_err,
                    "shard_cells": [int(host["q_mask"][:4].sum()), int(host["q_mask"][4:].sum())]}
    for name in ("tp", "sp") if gather_ok else ("tp",):
        shards = [r[name]["fwd"] for r in ranks]
        y = np.concatenate(shards, axis=1) if name == "sp" else shards[0]
        f_errs = [_rel_err(y, ref_fwd)] + ([_rel_err(shards[1], ref_fwd)] if name == "tp" else [])
        checks[f"b_{name}_forward"] = max(f_errs) <= PARALLEL_TOL
        line[f"b_{name}"] = {"forward_rel_err": f_errs, "checker": [r[name]["checker"] for r in ranks]}
        for variant, tol in (("", PARALLEL_GRAD_TOL), ("_smooth", PARALLEL_TOL)):
            ref_loss, ref_grads = ref_steps[variant]
            g_ok, g_err, g_leaf, g_med = _grads_ok(_grad_errs(r0[name][f"grads{variant}"], ref_grads), tol)
            checks[f"b_{name}{variant}_loss"] = all(abs(r[name][f"loss{variant}"] - ref_loss)
                                                    <= PARALLEL_TOL * abs(ref_loss) for r in ranks)
            same = ranks[1][name][f"digest{variant}"] == r0[name][f"digest{variant}"]
            checks[f"b_{name}{variant}_grads"] = g_ok and same
            line[f"b_{name}"][f"step{variant}"] = {
                "loss": [r[name][f"loss{variant}"] for r in ranks], "ref_loss": ref_loss, "grad_tol": tol,
                "worst_grad_rel_err": g_err, "leaf": g_leaf, "median_grad_rel_err": g_med}
        checks[f"c_{name}_launches"] = all(r[f"{name}_fwd_launches"] == fwd_expect
                                           and r[f"{name}_step_launches"] == r[f"{name}_smooth_step_launches"]
                                           == step_expect for r in ranks)
        checks[f"c_{name}_checker"] = all(r[name]["checker_ok"] and r[name]["checker"]["flash_fwd"]["launches"] == L
                                          and r[name]["control_caught"] for r in ranks)
        checks[f"c_{name}_step_checker"] = all(
            r[name][f"step_checker_ok{v}"] and all(r[name][f"step_checker{v}"][k]["launches"] == L for k in
                                                   ("flash_fwd", "flash_bwd_dq", "flash_bwd_dk", "flash_bwd_dv"))
            for r in ranks for v in ("", "_smooth"))
        line[f"b_{name}"]["step_checker"] = [{v or "kinked": r[name][f"step_checker{v}"] for v in ("", "_smooth")}
                                             for r in ranks]
    line["sp_two_ranks"] = "ran" if gather_ok else "not run: gloo's all_gather refused CUDA tensors"
    counts = dict(zero)
    for part in [a["fit"]["launches"], a["pf"]["launches"], a["sp_gather_launches"], a["sp_ring_launches"],
                 a["tp_launches"]] + [r[k] for r in ranks for k in r if k.endswith("_launches")]:
        for k, v in part.items():
            counts[k] += v
    line.update({"launches": counts, "seconds": {"references": round(t_ref, 1), "a": round(t_a, 1),
                                                 "b": round(t_b, 1), "total": round(time.time() - t0, 1)},
                 "note": "two ranks over gloo on one card: not NCCL scaling across cards"})
    line["checks"], line["ok"] = checks, all(checks.values())
    emit(line)
    if not line["ok"]:
        fail("parallel checks failed: " + ", ".join(k for k, v in checks.items() if not v))
    return counts


# ---------------------------------------------------------------------------
# phase: parallel_pf (stage-2 sequence and tensor parallelism; validation
# split over data-parallel ranks)
# ---------------------------------------------------------------------------

# the PF batch of the sharded paths: eight events padded to 2048 cells; under
# seq = 2 the events of 1024 and 900 cells hold every cell on the first shard
PF_PAR_LENGTHS = (2048, 2001, 1990, 1937, 1024, 900, 2047, 1500)
PF_PAR_N = 2048
# the split validations: the fixed-step sampler on three grid points (two
# midpoint steps, four evaluations of the model a batch)
VAL_METHOD, VAL_STEPS, VAL_EVALS = "midpoint", 3, 4


def synthetic_pf_trees(n, seed, max_part=4):
    """Stage-1 output trees in memory, the branches ``SRInference.predict``
    writes with ``store_energy_incidence`` (cells in MeV, some under the
    1 MeV cut; per-particle deposits ``e_part_i``; 1-4 particles an event)."""
    rng = np.random.default_rng(seed)
    trees = {"Low_Tree": {}, "High_Tree": {}, "Particle_Tree": {}}
    for name, e_key, lo, hi in (("Low_Tree", "e_meas_raw", 20, 60), ("High_Tree", "e_pred_raw", 60, 150)):
        trees[name] = {k: [] for k in ["eta_raw", "phi", "layer", e_key] + [f"e_part_{i}" for i in range(max_part)]}
    part = trees["Particle_Tree"] = {k: [] for k in ["particle_pt", "particle_eta", "particle_phi", "particle_e",
                                                     "particle_pdgid", "particle_dep_e"]}
    for _ in range(n):
        n_part = int(rng.integers(1, max_part + 1))
        for name, e_key, lo, hi in (("Low_Tree", "e_meas_raw", 20, 60), ("High_Tree", "e_pred_raw", 60, 150)):
            tree, n_cells = trees[name], int(rng.integers(lo, hi))
            tree["eta_raw"].append(rng.uniform(-2.5, 2.5, n_cells).astype(np.float32))
            tree["phi"].append(rng.uniform(-np.pi, np.pi, n_cells).astype(np.float32))
            tree["layer"].append(rng.integers(0, 3, n_cells).astype(np.float32))
            deposits = rng.exponential(8.0, (n_cells, max_part)).astype(np.float32)
            deposits[:, n_part:] = 0.0
            tree[e_key].append(deposits.sum(1) * rng.uniform(0.05, 1.2, n_cells).astype(np.float32))
            for i in range(max_part):
                tree[f"e_part_{i}"].append(deposits[:, i])
        e = rng.uniform(2.0, 100.0, n_part).astype(np.float32)
        eta = rng.uniform(-2.0, 2.0, n_part).astype(np.float32)
        part["particle_pt"].append(e / np.cosh(eta))
        part["particle_eta"].append(eta)
        part["particle_phi"].append(rng.uniform(-np.pi, np.pi, n_part).astype(np.float32))
        part["particle_e"].append(e)
        part["particle_pdgid"].append(rng.choice([22.0, 11.0, -11.0], n_part).astype(np.float32))
        part["particle_dep_e"].append(e * rng.uniform(0.5, 1.0, n_part).astype(np.float32))
    return trees


def pf_smooth_config(cfg_pf):
    """``cfg_pf`` with SiLU in place of the LeakyReLUs whose inputs another
    summation order moves (both DiT stacks' MLPs, after the attention sums;
    the cardinality MLP, after the pooled mean): the same parameters, no
    kink there (see ``PARALLEL_GRAD_TOL``).  The cell MLP's LeakyReLU acts on
    each cell's own features, before any sum over ranks."""
    import copy

    cfg_pf = copy.deepcopy(cfg_pf)
    for part in (cfg_pf["encoder"], cfg_pf["kinematics_predictor"]):
        part["transformer"]["dense_config"]["activation"] = "SiLU"
    cfg_pf["cardinality_predictor"]["activation"] = "SiLU"
    return cfg_pf


def parallel_pf_setup():
    """The published stage-2 configuration and training settings (validation
    batches of 4), its parameters (seed 3, Xavier adaLN: attention not gated
    off) in ``state_dict`` names, a (8, 2048) host batch of events of
    ``PF_PAR_LENGTHS`` cells (``budget_sized_pf_events`` from synthetic
    stage-1 trees), and the split validations' inputs: the multipart SR
    model's configs (fp32, fixed-step sampler, validation batches of 4) with
    six synthetic events, and ten low-resolution PF events."""
    import copy

    from superresolutionhep_tpu_torch.configs import MULTIPART_CONFIG_MV, MULTIPART_CONFIG_T, PF_CONFIG_MV, PF_CONFIG_T
    from superresolutionhep_tpu_torch.data.pf_dataset import PflowEvents, collate_pf
    from superresolutionhep_tpu_torch.tools.convert import init_pf_params_jax_layout, pf_params_from_jax

    cfg_mv = copy.deepcopy(PF_CONFIG_MV)
    cfg_pf = cfg_mv["pf_model"]
    cfg_t = dict(copy.deepcopy(PF_CONFIG_T), epoch_end_plots=False, batch_size_val=4, num_workers=0)
    params = {k[4:]: v for k, v in pf_params_from_jax(init_pf_params_jax_layout(cfg_pf, seed=3), cfg_pf).items()}
    pf_trees = synthetic_pf_trees(10, seed=41)
    ds = PflowEvents.from_trees(pf_trees, cfg_mv, energy_threshold=1.0, load_incidence=True)
    events = budget_sized_pf_events(ds, list(PF_PAR_LENGTHS), np.random.default_rng(29))
    host = collate_pf(events, PF_PAR_N, int(cfg_pf["max_particles"]))
    host = {k: v for k, v in host.items() if k != "idx"}
    sr_cfgs = (copy.deepcopy(MULTIPART_CONFIG_MV),
               dict(copy.deepcopy(MULTIPART_CONFIG_T), n_event_displays=0, val_ode_method=VAL_METHOD,
                    batch_size_val=4, use_sampler=False, num_workers=0, remat=False, fused_prologue=False))
    return {"cfg_mv": cfg_mv, "cfg_t": cfg_t, "params": params, "host": host, "pf_trees": pf_trees,
            "sr_cfgs": sr_cfgs}


def _pf_ref_step(setup, cfg_pf):
    """One process: the stage-2 forward and the loss and gradients of
    ``parallel/tp.py::make_pf_train_step`` with no mesh."""
    from superresolutionhep_tpu_torch.parallel.tp import make_pf_forward, make_pf_train_step
    from superresolutionhep_tpu_torch.transforms import build_var_transforms

    tr = build_var_transforms(setup["cfg_mv"]["var_transform"])
    params = {k: v.cuda() for k, v in setup["params"].items()}
    b = _dev_batch(setup["host"])
    _, fwd = make_pf_forward(cfg_pf, tr, None, device="cuda")
    with torch.no_grad():
        out = [x.float().cpu().numpy() for x in fwd(params, b)]
    _, step = make_pf_train_step(cfg_pf, tr, None, setup["cfg_t"], device="cuda")
    loss, grads = step(params, b)
    return out, float(loss), grads


def split_evaluations(setup, mesh=None, check=False):
    """``SRTrainer.evaluate`` (the multipart model, fp32, ``VAL_METHOD``) on
    six synthetic events and ``PFTrainer.evaluate`` (the published model,
    fp32) on ten, each rank its rows of every validation batch under
    ``mesh`` (none: one process): the metrics, each trainer's next draw from
    its generator, the batches, the launches of each window and, with
    ``check``, ``LaunchChecker``'s summary of every K1 launch."""
    import tempfile

    from superresolutionhep_tpu_torch.data.pf_dataset import PflowEvents
    from superresolutionhep_tpu_torch.train.pf_trainer import PFTrainer
    from superresolutionhep_tpu_torch.train.sr_trainer import SRTrainer

    sr_mv, sr_t = setup["sr_cfgs"]
    sr_ds = multipart_dataset(sr_mv, 6, 43, max_particles=4, window_lr_cells=2)
    pf_ds = PflowEvents.from_trees(setup["pf_trees"], setup["cfg_mv"], energy_threshold=1.0, load_incidence=True)
    out = {}
    for name, make, ds, kw in (
            ("sr", lambda: SRTrainer(sr_mv, sr_t, run_dir=tempfile.mkdtemp(prefix="srhep_val_"), seed=0,
                                     device="cuda", mesh=mesh), sr_ds, {"n_steps": VAL_STEPS}),
            ("pf", lambda: PFTrainer(setup["cfg_mv"], setup["cfg_t"], run_dir=tempfile.mkdtemp(prefix="srhep_val_"),
                                     seed=0, device="cuda", mesh=mesh), pf_ds, {})):
        tr = make()
        checker = LaunchChecker() if check else None
        if checker is not None:
            checker.__enter__()
        try:
            res, launches = _counted(lambda: tr.evaluate(ds, **kw))
        finally:
            if checker is not None:
                checker.__exit__(None, None, None)
        out[name] = {"metrics": res, "launches": launches, "batches": sum(1 for _ in tr._batcher(ds, "val", 0)),
                     "next_draw": torch.randn(4, generator=tr.generator, device="cuda")}
        if checker is not None:
            out[name].update(checker=checker.summary(), checker_ok=checker.ok())
        del tr
    return out


def parallel_pf_rank_nccl(rank, world_size, setup):
    """Phase (a), world size 1 over NCCL: the PF SP (gather, ring) and TP
    forwards and train steps at n = 1, and the split validations."""
    from superresolutionhep_tpu_torch.parallel.mesh import Mesh, shard_batch
    from superresolutionhep_tpu_torch.parallel.sp import make_pf_sp_forward, make_pf_sp_train_step
    from superresolutionhep_tpu_torch.parallel.tp import make_pf_tp_forward, make_pf_tp_train_step
    from superresolutionhep_tpu_torch.transforms import build_var_transforms

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg_pf, cfg_t = setup["cfg_mv"]["pf_model"], setup["cfg_t"]
    tr = build_var_transforms(setup["cfg_mv"]["var_transform"])
    params = {k: v.cuda() for k, v in setup["params"].items()}
    out = {}
    sp, tp = Mesh({"data": 1, "seq": 1}), Mesh({"data": 1, "model": 1})
    for name, mesh, make, kw in (("sp_gather", sp, make_pf_sp_forward, {"sp_mode": "gather"}),
                                 ("sp_ring", sp, make_pf_sp_forward, {"sp_mode": "ring"}),
                                 ("tp", tp, make_pf_tp_forward, {})):
        _, fwd = make(cfg_pf, tr, mesh, device="cuda", **kw)
        b = _dev_batch(shard_batch(setup["host"], mesh, cells=True, pf=True))
        with torch.no_grad():
            y, out[f"{name}_launches"] = _counted(lambda: fwd(params, b))
        out[name] = [x.float() for x in y]
    for name, mesh, make in (("sp_step", sp, make_pf_sp_train_step), ("tp_step", tp, make_pf_tp_train_step)):
        _, step = make(cfg_pf, tr, mesh, cfg_t, device="cuda")
        b = _dev_batch(shard_batch(setup["host"], mesh, cells=True, pf=True))
        (loss, grads), out[f"{name}_launches"] = _counted(lambda: step(params, b))
        out[name] = {"loss": float(loss), "grads": grads}
    out["val"] = split_evaluations(setup, Mesh({"data": 1}))
    return out


def parallel_pf_rank_gloo(rank, world_size, setup):
    """Phase (b) and (c), two ranks on the one card over gloo: the PF
    forward and train step at seq = 2 (gather) and at tp = 2, on the
    published weights and on the smooth ones, each window's launches,
    ``LaunchChecker`` on every K1 launch of the forwards with its
    planted-fault control and on every K1/K5/K6 launch of the steps; the
    split validations with every K1 launch under the checker."""
    from superresolutionhep_tpu_torch.parallel.mesh import Mesh, shard_batch
    from superresolutionhep_tpu_torch.parallel.sp import make_pf_sp_forward, make_pf_sp_train_step
    from superresolutionhep_tpu_torch.parallel.tp import make_pf_tp_forward, make_pf_tp_train_step
    from superresolutionhep_tpu_torch.transforms import build_var_transforms

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg_pf, cfg_t = setup["cfg_mv"]["pf_model"], setup["cfg_t"]
    tr = build_var_transforms(setup["cfg_mv"]["var_transform"])
    params = {k: v.cuda() for k, v in setup["params"].items()}
    out = {}
    for name, mesh, make_fwd, make_step in (
            ("sp", Mesh({"data": 1, "seq": 2}), make_pf_sp_forward, make_pf_sp_train_step),
            ("tp", Mesh({"data": 1, "model": 2}), make_pf_tp_forward, make_pf_tp_train_step)):
        b = _dev_batch(shard_batch(setup["host"], mesh, cells=True, pf=True))
        _, fwd = make_fwd(cfg_pf, tr, mesh, device="cuda")
        with LaunchChecker() as checker, torch.no_grad():
            y, out[f"{name}_fwd_launches"] = _counted(lambda: fwd(params, b))
        with LaunchChecker(fault=True) as control, torch.no_grad():
            fwd(params, b)
        out[name] = {"fwd": [x.float() for x in y], "coords": dict(zip(mesh.names, mesh.coords)),
                     "checker": checker.summary(), "checker_ok": checker.ok(), "control_caught": control.caught()}
        del fwd
        for variant, cfg in (("", cfg_pf), ("_smooth", pf_smooth_config(cfg_pf))):
            _, step = make_step(cfg, tr, mesh, cfg_t, device="cuda")
            with LaunchChecker(backward=True) as checker:
                (loss, grads), out[f"{name}{variant}_step_launches"] = _counted(lambda: step(params, b))
            out[name][f"step_checker{variant}"], out[name][f"step_checker_ok{variant}"] = (checker.summary(),
                                                                                          checker.ok())
            out[name][f"loss{variant}"] = float(loss)
            out[name][f"digest{variant}"] = [float(g.double().sum()) for g in grads.values()]
            if rank == 0:
                out[name][f"grads{variant}"] = grads
            del step
    out["val"] = split_evaluations(setup, Mesh({"data": 2}), check=True)
    return out


def _val_close(got, want):
    """The largest relative difference over the metrics (inf where the keys
    differ)."""
    if set(got) != set(want):
        return float("inf")
    return max(abs(got[k] - want[k]) / max(abs(want[k]), 1e-30) for k in want)


def parallel_pf_phase():
    """Stage-2 sequence and tensor parallelism and the validation split over
    data-parallel ranks, on the one card, at the published stage-2 width
    (h 64, 3 encoder DiT layers and 4 kinematics cross-attention layers of 4
    heads of 16; fp32) on a (8, 2048) batch, and the multipart SR model's
    validation at full width (h 256, 6 DiT layers; fp32, the fixed-step
    ``VAL_METHOD``).

    (a) World size 1 over NCCL: ``make_pf_sp_forward`` (gather, ring),
    ``make_pf_tp_forward``, ``make_pf_sp_train_step`` and
    ``make_pf_tp_train_step`` at n = 1 against the same functions with no
    process group (``mesh=None``), equal bit for bit but the ring (its
    online softmax is another formulation: within ``PARALLEL_TOL``); a split
    ``SRTrainer.evaluate`` and ``PFTrainer.evaluate`` (a ``data`` mesh of one)
    equal to the trainers' with no group bit for bit, their generators still
    in step.
    (b) Two ranks on the one card over gloo: seq = 2 (gather; K1 with 1024
    local queries against 2048 keys, 4 heads of 16; the events of 1024 and
    900 cells lie on the first shard alone) and tp = 2 (2 heads of 16 a
    rank) forwards and train steps against one rank (``PARALLEL_TOL``; the
    gradients ``PARALLEL_GRAD_TOL``, and on the weights of
    ``pf_smooth_config`` ``PARALLEL_TOL``), and the split validations (each
    rank two rows of every batch) against one rank (``PARALLEL_TOL`` on
    every metric; the generators in step).
    (c) Each rank's launches per window are exact: 3 K1 a PF forward, 3 K1 +
    3 K5 + 3 K6 a step (the kinematics cross-attention's 4 particle queries
    take the dense path), ``VAL_EVALS`` x 6 K1 an SR validation batch, 3 K1
    a PF one; ``LaunchChecker`` holds every K1 launch of the forwards, with
    its planted-fault control, every K1/K5/K6 launch of the steps and every
    K1 launch of the split validations against their plain versions.  The
    ring at two ranks is not run here: gloo's send/recv take no CUDA
    tensors."""
    from superresolutionhep_tpu_torch.ops import kernels
    from superresolutionhep_tpu_torch.parallel.launch import run_ranks

    t0 = time.time()
    zero = {k: 0 for k in kernels.LAUNCHES}
    checks, line = {}, {"phase": "parallel_pf"}
    setup = parallel_pf_setup()
    cfg_pf = setup["cfg_mv"]["pf_model"]
    n_enc = int(cfg_pf["encoder"]["transformer"]["num_transformer_layers"])
    L_sr = int(setup["sr_cfgs"][0]["flow_model"]["transformer"]["num_transformer_layers"])

    # ---- one process, no group
    ref_fwd, ref_loss, ref_grads = _pf_ref_step(setup, cfg_pf)
    ref_smooth = _pf_ref_step(setup, pf_smooth_config(cfg_pf))[1:]
    ref_val = split_evaluations(setup)
    t_ref = time.time() - t0

    # ---- (a) world size 1 over NCCL
    t1 = time.time()
    (a,) = run_ranks(parallel_pf_rank_nccl, 1, (setup,), backend="nccl", device="cuda", timeout_s=PARALLEL_TIMEOUT_S)
    t_a = time.time() - t1
    fwd_expect = dict(zero, flash_fwd=n_enc)
    step_expect = dict(zero, flash_fwd=n_enc, flash_bwd_dq=n_enc, flash_bwd_dkv=n_enc)

    def bit_equal(x, y):
        return all(np.array_equal(np.asarray(u, np.float32).view(np.uint32), np.asarray(v, np.float32).view(np.uint32))
                   for u, v in zip(x, y))

    checks["a_forwards_bit_equal"] = bit_equal(a["sp_gather"], ref_fwd) and bit_equal(a["tp"], ref_fwd)
    ring_err = max(_rel_err(u, v) for u, v in zip(a["sp_ring"], ref_fwd))
    checks["a_ring_forward"] = ring_err <= PARALLEL_TOL
    ref_g = [v.float().cpu().numpy() for v in ref_grads.values()]
    checks["a_steps_bit_equal"] = all(
        a[n]["loss"] == ref_loss and list(a[n]["grads"]) == list(ref_grads) and bit_equal(a[n]["grads"].values(), ref_g)
        for n in ("sp_step", "tp_step"))
    checks["a_launches"] = (a["sp_gather_launches"] == a["tp_launches"] == fwd_expect and a["sp_ring_launches"] == zero
                            and a["sp_step_launches"] == a["tp_step_launches"] == step_expect)

    def val_expect(v):
        per_batch = {"sr": VAL_EVALS * L_sr, "pf": n_enc}
        return {k: dict(zero, flash_fwd=per_batch[k] * v[k]["batches"]) for k in ("sr", "pf")}

    vexp = val_expect(ref_val)
    checks["a_val_bit_equal"] = all(a["val"][k]["metrics"] == ref_val[k]["metrics"]
                                    and np.array_equal(a["val"][k]["next_draw"],
                                                       ref_val[k]["next_draw"].cpu().numpy()) for k in ("sr", "pf"))
    checks["a_val_launches"] = all(a["val"][k]["launches"] == ref_val[k]["launches"] == vexp[k] for k in ("sr", "pf"))
    line["a"] = {"ring_forward_rel_err": ring_err, "loss": ref_loss, "seconds": round(t_a, 1),
                 "val": {k: a["val"][k]["metrics"] for k in ("sr", "pf")}}

    # ---- (b), (c) two ranks on the one card over gloo
    t1 = time.time()
    ranks = run_ranks(parallel_pf_rank_gloo, 2, (setup,), backend="gloo", device="cuda:0",
                      timeout_s=PARALLEL_TIMEOUT_S)
    t_b = time.time() - t1
    r0 = ranks[0]
    for name in ("sp", "tp"):
        if name == "sp":  # the incidence weights by cell shard, the rest whole on each rank
            y = [ranks[0][name]["fwd"][0], ranks[0][name]["fwd"][1],
                 np.concatenate([r[name]["fwd"][2] for r in ranks], axis=2)]
        else:
            y = ranks[0][name]["fwd"]
        f_errs = [_rel_err(u, v) for u, v in zip(y, ref_fwd)] + [
            _rel_err(u, v) for u, v in zip(ranks[1][name]["fwd"][:2], ref_fwd[:2])]
        checks[f"b_{name}_forward"] = max(f_errs) <= PARALLEL_TOL
        line[f"b_{name}"] = {"forward_rel_err": f_errs, "checker": [r[name]["checker"] for r in ranks]}
        for variant, (r_loss, r_grads), tol in (("", (ref_loss, ref_grads), PARALLEL_GRAD_TOL),
                                                 ("_smooth", ref_smooth, PARALLEL_TOL)):
            g_ok, g_err, g_leaf, g_med = _grads_ok(_grad_errs(r0[name][f"grads{variant}"], r_grads), tol)
            checks[f"b_{name}{variant}_loss"] = all(abs(r[name][f"loss{variant}"] - r_loss) <= PARALLEL_TOL * abs(r_loss)
                                                    for r in ranks)
            same = ranks[1][name][f"digest{variant}"] == r0[name][f"digest{variant}"]
            checks[f"b_{name}{variant}_grads"] = g_ok and same
            line[f"b_{name}"][f"step{variant}"] = {
                "loss": [r[name][f"loss{variant}"] for r in ranks], "ref_loss": r_loss, "grad_tol": tol,
                "worst_grad_rel_err": g_err, "leaf": g_leaf, "median_grad_rel_err": g_med}
        checks[f"c_{name}_launches"] = all(r[f"{name}_fwd_launches"] == fwd_expect
                                           and r[f"{name}_step_launches"] == r[f"{name}_smooth_step_launches"]
                                           == step_expect for r in ranks)
        checks[f"c_{name}_checker"] = all(r[name]["checker_ok"] and r[name]["checker"]["flash_fwd"]["launches"] == n_enc
                                          and r[name]["control_caught"] for r in ranks)
        checks[f"c_{name}_step_checker"] = all(
            r[name][f"step_checker_ok{v}"] and all(r[name][f"step_checker{v}"][k]["launches"] == n_enc for k in
                                                   ("flash_fwd", "flash_bwd_dq", "flash_bwd_dk", "flash_bwd_dv"))
            for r in ranks for v in ("", "_smooth"))
        line[f"b_{name}"]["step_checker"] = [{v or "kinked": r[name][f"step_checker{v}"] for v in ("", "_smooth")}
                                             for r in ranks]
    val_errs = {k: [_val_close(r["val"][k]["metrics"], ref_val[k]["metrics"]) for r in ranks]
                for k in ("sr", "pf")}
    checks["b_val"] = all(e <= PARALLEL_TOL for v in val_errs.values() for e in v) and all(
        np.array_equal(r["val"][k]["next_draw"], ref_val[k]["next_draw"].cpu().numpy()) for r in ranks
        for k in ("sr", "pf"))
    checks["c_val_launches"] = all(r["val"][k]["launches"] == dict(zero, flash_fwd=vexp[k]["flash_fwd"])
                                   for r in ranks for k in ("sr", "pf"))
    checks["c_val_checker"] = all(r["val"][k]["checker_ok"] and r["val"][k]["checker"]["flash_fwd"]["launches"]
                                  == vexp[k]["flash_fwd"] for r in ranks for k in ("sr", "pf"))
    line["b_val"] = {"rel_err": val_errs, "metrics": {k: [r["val"][k]["metrics"] for r in ranks] for k in ("sr", "pf")},
                     "ref_metrics": {k: ref_val[k]["metrics"] for k in ("sr", "pf")},
                     "batches": {k: ref_val[k]["batches"] for k in ("sr", "pf")},
                     "checker": [{k: r["val"][k]["checker"] for k in ("sr", "pf")} for r in ranks]}
    counts = dict(zero)
    parts = [a[k] for k in a if k.endswith("_launches")] + [a["val"][k]["launches"] for k in ("sr", "pf")]
    parts += [r[k] for r in ranks for k in r if k.endswith("_launches")]
    parts += [r["val"][k]["launches"] for r in ranks for k in ("sr", "pf")]
    for part in parts:
        for k, v in part.items():
            counts[k] += v
    line.update({"launches": counts, "seconds": {"references": round(t_ref, 1), "a": round(t_a, 1),
                                                 "b": round(t_b, 1), "total": round(time.time() - t0, 1)},
                 "note": "two ranks over gloo on one card: not NCCL scaling across cards"})
    line["checks"], line["ok"] = checks, all(checks.values())
    emit(line)
    if not line["ok"]:
        fail("parallel_pf checks failed: " + ", ".join(k for k, v in checks.items() if not v))
    return counts


# ---------------------------------------------------------------------------
# phase: closure (the shipped closure checkpoints on their suites' test events)
# ---------------------------------------------------------------------------

# the SR closure's iqr_ratio is held to the JAX package's reading on the CPU
# on the same events with the same settings (``python
# tests/test_torch_port_closure.py jax_sr_reading fp32|bf16``; in bf16 with
# the attention kernel's plain reference, fp32 scores, as on a TPU: the CPU's
# einsum fallback rounds scores to bf16 and reads another function; the
# shipped JSON is printed beside it: ``ROADMAP.md`` C6): the ensemble's noise
# is a torch draw here, so only the cell count is exact.  The band of each is
# three times the spread of the port's readings over the noise seeds 0-2 on
# an H100 (``python3 chip_smoke.py --closure-variants``), rounded up to a
# whole percent, at least 3%: fp32 45.61-46.07 (1.0%), bf16 36.28-36.78 (1.4%)
CLOSURE_SR_JAX = {tag: os.path.join("tests", "golden_torch", f"closure_sr_jax_{tag}.json") for tag in ("fp32", "bf16")}
CLOSURE_SR_TOL = {"fp32": 0.03, "bf16": 0.05}
# the PF model's slots are embeddings (no noise): its readings are held to
# 0.02 (accuracy) and 10% (IQRs, incidence MAE) of the shipped ones
CLOSURE_PF_REL_TOL = 0.10
CLOSURE_CARD_TOL = 0.02
CLOSURE_N_EVENTS = 256  # both suites' test split (--n-test)
CLOSURE_SR_RUN = {"n_steps": 25, "n_ensemble": 10, "method": "ab2e"}  # closure_suite.py's inference


def closure_events():
    """Both suites' 256 test events (``closure_suite.GEN`` with seed 13,
    ``closure_pf_suite.GEN`` with seed 23), made in two spawned processes
    while the caller goes on: ~9 and ~16 s of host numpy work.  Futures of
    the trees, by suite; the processes end with their work."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    from superresolutionhep_tpu_torch.data.synthetic import GeneratorConfig, generate_events
    from superresolutionhep_tpu_torch.scripts import closure_pf_suite as cps
    from superresolutionhep_tpu_torch.scripts import closure_suite as cs

    pool = ProcessPoolExecutor(2, mp_context=multiprocessing.get_context("spawn"))
    futures = {name: pool.submit(generate_events, CLOSURE_N_EVENTS, seed=suite.SPLIT_SEEDS["test"],
                                 config=GeneratorConfig(**suite.GEN)) for name, suite in (("sr", cs), ("pf", cps))}
    pool.shutdown(wait=False)
    return futures


def _window(fn, chk=None):
    """``fn()`` with the launch counters reset just before and read just
    after, inside ``chk`` (a ``LaunchChecker``) where one is given."""
    import contextlib

    from superresolutionhep_tpu_torch.ops import kernels

    kernels.reset_launches()
    with chk or contextlib.nullcontext():
        out = fn()
    torch.cuda.synchronize()
    return out, dict(kernels.LAUNCHES)


def _n_batches(counts, quantum, batch_size):
    from superresolutionhep_tpu_torch.data.bucketing import BucketBatcher

    return sum(1 for _ in BucketBatcher(counts, quantum=quantum, max_batch_size=batch_size, shuffle=False))


def _first_batch_control(model, ds, counts, quantum, batch_size, collate_fn, apply):
    """One evaluation of ``model`` on the run's first batch with the planted
    fault (``LaunchChecker(fault=True)``, the windows' own rule): its
    ``tally`` of K1's launches."""
    from superresolutionhep_tpu_torch.data.bucketing import BucketBatcher

    idxs, bucket = next(iter(BucketBatcher(counts, quantum=quantum, max_batch_size=batch_size, shuffle=False)))
    batch = collate_fn([ds.get_event(int(i)) if i >= 0 else None for i in idxs], bucket.pad_n)
    with torch.no_grad(), LaunchChecker(fault=True) as bad:
        apply(model, batch)
    return bad.tally("flash_fwd")


def _beside(got, shipped, keys):
    return {k: {"port": got.get(k), "shipped": shipped.get(k)} for k in keys}


def _sr_closure_dataset(truth):
    from superresolutionhep_tpu_torch.configs import CLOSURE_SR_CONFIG_MV
    from superresolutionhep_tpu_torch.data.sr_dataset import SupResEvents

    return SupResEvents.from_trees(truth["Low_Tree"], truth["High_Tree"], CLOSURE_SR_CONFIG_MV, make_low=True,
                                   make_particles=True)


def _sr_closure_model(dtype):
    """``closure_sr`` from its blob as the suite's inference builds it; dtype
    None (fp32, the suite's default) or "bfloat16" (the bf16 stack)."""
    from superresolutionhep_tpu_torch.configs import CLOSURE_SR_CONFIG_MV, CLOSURE_SR_CONFIG_T, CLOSURE_SR_DIR
    from superresolutionhep_tpu_torch.inference.sr import SRInference
    from superresolutionhep_tpu_torch.scripts import closure_suite as cs

    cfg = cs.infer_model_config(CLOSURE_SR_RUN["n_steps"], os.path.join(ROOT, CLOSURE_SR_DIR, "params.msgpack"),
                                config_mv=CLOSURE_SR_CONFIG_MV, config_t=CLOSURE_SR_CONFIG_T)
    return SRInference({"model": dict(cfg, **({"dtype": dtype} if dtype else {}))}, device="cuda")


def _sr_closure(inf, ds, method=CLOSURE_SR_RUN["method"], seed=0, chk=None):
    """One SR closure run: ``inf.predict`` on ``ds`` with the suite's
    settings in a counted window (inside ``chk``), scored by the suite's
    ``closure_metrics``; the metrics, the launch counts and the seconds."""
    from superresolutionhep_tpu_torch.scripts import closure_suite as cs

    item = dict(cs.infer_item(CLOSURE_SR_RUN["n_ensemble"], ode_method=method, max_particles=1), seed=seed)
    t0 = time.time()
    pred, counts = _window(lambda: inf.predict(ds, item), chk)
    return cs.closure_metrics(pred["High_Tree"]), counts, round(time.time() - t0, 2)


def closure_phase(events=None):
    """Both shipped closure checkpoints on their suites' 256 test events, in
    memory (the card's machine has no h5py), through ``SRInference.predict``
    / ``PFInference.predict`` and the suites' own metric cores
    (``scripts/closure_suite.py::closure_metrics``,
    ``scripts/closure_pf_suite.py::pf_closure_metrics``), beside the
    metrics shipped with each checkpoint.  ``events``: ``closure_events()``
    started earlier (made here when None).
      * SR: ``closure_sr`` from its msgpack blob (the multipart model with 9
        Fourier octaves at full width) on ``closure_suite.GEN`` with the test
        seed 13, with the suite's inference settings: the robust attention,
        10 members, ``ab2e`` at 25 grid points, batches of 64; exactly 6 K1
        per model evaluation: 6 x 24 x the batches.  Twice: in fp32 (the
        suite's default: the model config sets no dtype) and with the bf16
        stack (fp32 geometry, the precision the shipped metrics were
        produced in, docs/CLOSURE.md), each iqr_ratio within
        ``CLOSURE_SR_TOL`` of the JAX package's reading in that precision on
        the same events (``CLOSURE_SR_JAX``).  In both ``n_cells`` equals the
        shipped 46733 (the generator and the cut) and the gate iqr_ratio >=
        1.5 holds.
      * PF: ``closure_pf_suite.GEN`` with seed 23 through the suite's LR
        passthrough (random SR weights, ``euler`` at 2 steps, one member,
        the energy incidence of 4 particles: 6 K1 a batch, in a window of
        its own), then ``closure_pf`` from its blob with its training
        config (resolution low, batches of 64, the incidence weights):
        exactly 3 K1 a batch.  ``n_events`` 256, the gate accuracy >= 0.8,
        accuracy within 0.02 of the shipped 0.9414, the three residual IQRs
        and the incidence MAE within 10% of the shipped values.
    The fp32 K1 launches are held against their plain version
    (``LaunchChecker``): in the fp32 SR window the first batch's (144 of
    576: checking every launch there would take the phase past a minute), in
    the passthrough and PF windows every launch.  A planted fault on each
    fp32 model's first batch must fail every launch it touches, and on
    ``closure_sr`` some of those launches must be ill-conditioned (the fault
    seen under the ``EXACT_RATIO`` rule).  The bf16 window counts its
    launches; bf16 K1 is held in the serve, trained and Normformer phases."""
    from superresolutionhep_tpu_torch.configs import (CLOSURE_PF_DIR, CLOSURE_SR_CONFIG_MV, CLOSURE_SR_CONFIG_T,
                                                      CLOSURE_SR_DIR, PF_CONFIG_MV, PF_CONFIG_T)
    from superresolutionhep_tpu_torch.data.pf_dataset import PflowEvents, collate_pf
    from superresolutionhep_tpu_torch.data.sr_dataset import MODEL_BATCH_KEYS, SupResEvents, collate
    from superresolutionhep_tpu_torch.inference.pf import PFInference, pf_batch_to_device
    from superresolutionhep_tpu_torch.inference.sr import batch_to_device
    from superresolutionhep_tpu_torch.ops import kernels
    from superresolutionhep_tpu_torch.scripts import closure_pf_suite as cps
    from superresolutionhep_tpu_torch.scripts import closure_suite as cs
    from superresolutionhep_tpu_torch.tools.flops import sampler_evals

    t_phase = time.time()
    events = events or closure_events()
    zero = {k: 0 for k in kernels.LAUNCHES}
    total, checks, seconds = dict(zero), {}, {}
    line = {"phase": "closure", "events": CLOSURE_N_EVENTS}
    n_sr_layers = int(CLOSURE_SR_CONFIG_MV["flow_model"]["transformer"]["num_transformer_layers"])
    dev = torch.device("cuda")

    def sr_apply(model, host):
        b = batch_to_device(host, dev, MODEL_BATCH_KEYS)
        model(b, torch.zeros_like(b["e_proxy"]), torch.full((b["eta"].shape[0],), 0.5, device=dev))

    def control_caught(tally, ill=False):  # every launch fails; with ill, some ill-conditioned
        return tally["launches"] > 0 and tally["failed"] == tally["launches"] and (not ill or tally["ill_failed"] > 0)

    # ---- (a) SR closure on closure_sr in fp32 (the suite's settings) and
    # with the bf16 stack (the shipped run's precision, docs/CLOSURE.md),
    # each against the JAX package's reading in that precision
    with open(os.path.join(ROOT, CLOSURE_SR_DIR, "closure_metrics.json")) as fp:
        shipped = json.load(fp)
    t0 = time.time()
    ds = _sr_closure_dataset(events["sr"].result())
    seconds["sr_events_wait"] = round(time.time() - t0, 2)
    quantum = int(CLOSURE_SR_CONFIG_T.get("bucket_quantum", 128))
    n_batches = _n_batches(ds.cell_count_high, quantum, cs.INFER_BATCH)
    per_batch = n_sr_layers * sampler_evals(CLOSURE_SR_RUN["n_steps"], CLOSURE_SR_RUN["method"])
    line["sr"] = {"checkpoint": CLOSURE_SR_DIR, "generator_seed": cs.SPLIT_SEEDS["test"], **CLOSURE_SR_RUN,
                  "batches": n_batches, "attention": "robust K1"}
    keys = ("n_cells", "naive_iqr", "pred_iqr", "iqr_ratio", "naive_std", "pred_std")
    for tag, dtype in (("fp32", None), ("bf16", "bfloat16")):
        with open(os.path.join(ROOT, CLOSURE_SR_JAX[tag])) as fp:
            jax_ref = json.load(fp)
        inf = _sr_closure_model(dtype)
        checks[f"sr_{tag}_robust"] = not inf.fast_softmax and (inf.dtype is None) == (dtype is None)
        chk = LaunchChecker(first=per_batch) if tag == "fp32" else None
        got, counts, seconds[f"sr_{tag}_predict"] = _sr_closure(inf, ds, chk=chk)
        total = {k: total[k] + counts[k] for k in total}
        checks[f"sr_{tag}_launch_counts"] = counts == dict(zero, flash_fwd=per_batch * n_batches)
        checks[f"sr_{tag}_n_cells"] = got["n_cells"] == shipped["n_cells"] == jax_ref["n_cells"]
        checks[f"sr_{tag}_gate_iqr_ratio_ge_1p5"] = got["iqr_ratio"] >= 1.5
        checks[f"sr_{tag}_iqr_ratio_within_tol_of_jax"] = (
            abs(got["iqr_ratio"] / jax_ref["iqr_ratio"] - 1.0) <= CLOSURE_SR_TOL[tag])
        line["sr"][tag] = {
            "held_to": CLOSURE_SR_JAX[tag], "tol_rel": CLOSURE_SR_TOL[tag],
            "iqr_ratio": {"port": got["iqr_ratio"], "jax_cpu": jax_ref["iqr_ratio"], "shipped": shipped["iqr_ratio"]},
            "metrics": _beside(got, shipped, keys), "jax_cpu": {k: jax_ref.get(k) for k in keys},
            "per_layer": {L: {**_beside(got["per_layer"].get(L, {}), v, ("n", "naive_iqr", "pred_iqr", "iqr_ratio")),
                              "jax_cpu_iqr_ratio": jax_ref["per_layer"][L]["iqr_ratio"]}
                          for L, v in shipped["per_layer"].items()},
            "launches": {k: v for k, v in counts.items() if v}}
        if chk is not None:
            checks[f"sr_{tag}_vs_plain"] = chk.ok() and chk.calls.get("flash_fwd") == per_batch
            t0 = time.time()
            tally = _first_batch_control(inf.model, ds, ds.cell_count_high, quantum, cs.INFER_BATCH, collate, sr_apply)
            seconds[f"sr_{tag}_control"] = round(time.time() - t0, 2)
            checks[f"sr_{tag}_control_caught"] = control_caught(tally, ill=True)
            line["sr"][tag].update(vs_plain=chk.summary(), control=tally,
                                   checked=f"the first batch's {per_batch} launches of {per_batch * n_batches}")
        del inf

    # ---- (b) PF closure on closure_pf, after the suite's LR passthrough
    with open(os.path.join(ROOT, CLOSURE_PF_DIR, "closure_pf_metrics.json")) as fp:
        shipped = json.load(fp)
    passthrough = cps.passthrough_inference(CLOSURE_SR_CONFIG_MV, device="cuda")
    t0 = time.time()
    truth = events["pf"].result()
    seconds["pf_events_wait"] = round(time.time() - t0, 2)
    sr_ds = SupResEvents.from_trees(truth["Low_Tree"], truth["High_Tree"], passthrough.config_mv, make_low=True,
                                    make_particles=True)
    pt_item = cps.PASSTHROUGH_ITEM
    pt_batches = _n_batches(sr_ds.cell_count_high, int(cps.PASSTHROUGH_T.get("bucket_quantum", 128)),
                            pt_item["batch_size"])
    t0 = time.time()
    chk_pt = LaunchChecker()
    sr_trees, counts = _window(lambda: passthrough.predict(sr_ds, pt_item), chk_pt)
    seconds["passthrough_checked"] = round(time.time() - t0, 2)
    total = {k: total[k] + counts[k] for k in total}
    checks["passthrough_launch_counts"] = counts == dict(
        zero, flash_fwd=n_sr_layers * sampler_evals(2, pt_item["ode_method"]) * pt_batches)
    checks["passthrough_vs_plain"] = chk_pt.ok()
    del passthrough

    pf = PFInference({"model": {"config_mv": PF_CONFIG_MV, "config_t": PF_CONFIG_T,
                                "checkpoint_path": os.path.join(ROOT, CLOSURE_PF_DIR, "params.msgpack")},
                      "batch_size": 64}, device="cuda")
    pf_ds = PflowEvents.from_trees(sr_trees, PF_CONFIG_MV, energy_threshold=float(PF_CONFIG_T["energy_threshold"]),
                                   res=PF_CONFIG_T["resolution"], load_incidence=pf.loss_on_inc)
    pf_quantum = int(PF_CONFIG_T["bucket_quantum"])
    pf_batches = _n_batches(pf_ds.cell_count, pf_quantum, 64)
    n_enc = int(PF_CONFIG_MV["pf_model"]["encoder"]["transformer"]["num_transformer_layers"])
    t0 = time.time()
    chk_pf = LaunchChecker()
    pf_pred, counts = _window(lambda: pf.predict(pf_ds, {"store_inc_wt": True}), chk_pf)
    seconds["pf_predict_checked"] = round(time.time() - t0, 2)
    total = {k: total[k] + counts[k] for k in total}
    checks["pf_launch_counts"] = counts == dict(zero, flash_fwd=n_enc * pf_batches)
    checks["pf_vs_plain"] = chk_pf.ok() and chk_pf.dtypes.get("flash_fwd") == torch.float32
    tally_pf = _first_batch_control(
        pf.model, pf_ds, pf_ds.cell_count, pf_quantum, 64,
        lambda events, pad_n: collate_pf(events, pad_n, pf.max_part),
        lambda model, host: model(pf_batch_to_device(host, dev)))
    checks["pf_control_caught"] = control_caught(tally_pf)
    got = cps.pf_closure_metrics(pf_pred["Particle_Tree"], sr_trees["Low_Tree"])
    checks["pf_n_events"] = got["n_events"] == shipped["n_events"] == CLOSURE_N_EVENTS
    checks["pf_gate_cardinality_ge_0p8"] = got["cardinality_accuracy"] >= 0.8
    checks["pf_cardinality_within_0p02"] = abs(got["cardinality_accuracy"]
                                               - shipped["cardinality_accuracy"]) <= CLOSURE_CARD_TOL
    rel = {k: abs(got["residual_iqr"][k] / v - 1.0) for k, v in shipped["residual_iqr"].items()}
    rel["incidence_mae"] = abs(got.get("incidence_mae", float("inf")) / shipped["incidence_mae"] - 1.0)
    checks["pf_residual_iqrs_and_incidence_within_10pct"] = max(rel.values()) <= CLOSURE_PF_REL_TOL
    line["pf"] = {
        "checkpoint": CLOSURE_PF_DIR, "generator_seed": cps.SPLIT_SEEDS["test"], "resolution": PF_CONFIG_T["resolution"],
        "batches": pf_batches, "passthrough_batches": pt_batches,
        "metrics": _beside(got, shipped, ("n_events", "cardinality_accuracy", "cardinality_accuracy_by_n",
                                          "residual_iqr", "n_incidence_branches", "incidence_mae")),
        "rel_dev": rel, "tol_rel": CLOSURE_PF_REL_TOL, "tol_cardinality": CLOSURE_CARD_TOL,
        "launches": {k: v for k, v in counts.items() if v}, "vs_plain": chk_pf.summary(),
        "passthrough_vs_plain": chk_pt.summary(), "control": tally_pf}
    seconds["phase"] = round(time.time() - t_phase, 1)
    line.update(launches={k: v for k, v in total.items() if v}, seconds=seconds,
                checker="SR fp32: the first batch's launches; passthrough and PF: every launch; SR bf16: counted only",
                checks=checks, ok=all(checks.values()))
    emit(line)
    if not line["ok"]:
        fail("closure checks failed: " + ", ".join(k for k, v in checks.items() if not v))
    return total


def closure_variants():
    """The SR closure of ``closure_sr`` around the closure phase's two runs
    (``python3 chip_smoke.py --closure-variants``): the noise seed (0, 1,
    2) and the sampler (``ab2e``, ``ab2``) in fp32 and with the bf16 stack,
    each run's iqr_ratio and per-layer ratios; in the fp32 ``ab2e`` run with
    seed 0 every K1 launch held (``LaunchChecker``), with the launches that
    miss ``TOL`` against the plain version counted by DiT layer and their
    distances from fp64.  One JSON line per run."""
    ds = _sr_closure_dataset(closure_events()["sr"].result())
    tol = TOL[("flash", torch.float32)]
    for dtype in (None, "bfloat16"):
        inf = _sr_closure_model(dtype)
        for method, seed in (("ab2e", 0), ("ab2e", 1), ("ab2e", 2), ("ab2", 0)):
            chk = LaunchChecker() if dtype is None and (method, seed) == ("ab2e", 0) else None
            got, counts, secs = _sr_closure(inf, ds, method=method, seed=seed, chk=chk)
            line = {"phase": "closure_variant", "method": method, "dtype": "bf16" if dtype else "fp32", "seed": seed,
                    "iqr_ratio": got["iqr_ratio"], "pred_iqr": got["pred_iqr"],
                    "per_layer": {L: v["iqr_ratio"] for L, v in got["per_layer"].items()},
                    "launches": counts["flash_fwd"], "seconds": secs}
            if chk is not None:
                # launch i is DiT layer i % 6 of one model evaluation
                over = [(i, r) for i, r in enumerate(chk.records) if r["max_rel_err"] > tol]
                line["checker"] = {
                    "summary": chk.summary(), "over_tol_vs_plain": len(over),
                    "over_by_layer": {L: sum(1 for i, _ in over if i % 6 == L) for L in range(6)},
                    "over_max_kernel_vs_fp64": max((r["kernel_vs_fp64"] for _, r in over), default=None),
                    "over_max_plain_vs_fp64": max((r["plain_vs_fp64"] for _, r in over), default=None),
                    "over_max_kernel_over_plain": max((r["kernel_vs_fp64"] / r["plain_vs_fp64"] for _, r in over),
                                                      default=None)}
            emit(line)
        del inf


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip-serve", action="store_true")
    ap.add_argument("--skip-train", action="store_true")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--closure-variants", action="store_true")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        sys.exit(2)
    t_start = time.time()
    from superresolutionhep_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from superresolutionhep_tpu_torch.scripts.common import card

    smi = card()
    import importlib.util

    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
          # the live validation plots (n_event_displays > 0) need it
          "matplotlib": importlib.util.find_spec("matplotlib") is not None})

    t0 = time.time()
    lib = kernels.build(verbose=True)
    kernels.library()
    emit({"phase": "build", "library": str(lib.name), "seconds": round(time.time() - t0, 2),
          "nvcc_flags": list(kernels.NVCC_FLAGS)})
    if args.ptxas:
        print((kernels.build_dir() / "nvcc_log.txt").read_text(), flush=True)
    if (kernels.build_dir() / "nvcc_log.txt").exists():  # absent when the library was built before, elsewhere
        report = ptxas_report()
        emit({"phase": "ptxas", **report})
        if not report["ok"]:
            fail("ptxas: a wgmma or fp32 attention kernel spills, or ptxas serialised its wgmma instructions")
    if args.closure_variants:
        closure_variants()
        print(smi, flush=True)
        return

    cases = (kernel_cases(args.reps) + fwd_tile_cases(args.reps) + bwd_kernel_cases(args.reps)
             + bwd_tile_cases() + fp32_tile_cases() + packed_kernel_cases(args.reps) + probe_kernel_cases(args.reps))
    zero = {k: 0 for k in kernels.LAUNCHES}
    closure = closure_events()  # host work beside the phases before the closure phase
    by_phase = {"probes": probes_phase(args.reps),
                "serve": serve_phase() if not args.skip_serve else zero,
                "packed_inference": packed_inference_phase() if not args.skip_serve else zero,
                "train": train_phase(args.reps) if not args.skip_train else zero,
                "dopri5_ensemble": dopri5_ensemble_phase() or zero if not args.skip_train else zero,
                "packed_train": packed_train_phase(args.reps) if not args.skip_train else zero}
    if not (args.skip_serve and args.skip_train):
        trees = sr_predicted_trees()
        by_phase["pf_inference"] = pf_inference_phase(trees) if not args.skip_serve else zero
        by_phase["pf_train"] = pf_train_phase(trees, args.reps) if not args.skip_train else zero
        by_phase["trained"] = trained_phase(trees, args.reps) if not args.skip_serve else zero
    by_phase["normformer"] = normformer_phase() if not args.skip_serve else zero
    by_phase["parallel"] = parallel_phase()
    by_phase["parallel_pf"] = parallel_pf_phase()
    by_phase["closure"] = closure_phase(closure)

    # one entry per kernel: the main paths' shape class (bf16; L=2048 with
    # per-batch rows for K1-K6, the (8, 5120) packed batch for K7-K9, the
    # scripts' (8, 8, 2048, 64) for K10 in mode full and K11 with bf16 exp and
    # the all-ones mask); launches: the counted windows of the path phases
    def entry_case(name):
        if name == "probe_variant":
            return next(c for c in cases if c["kernel"] == name and c["L"] == 2048 and c.get("mode") == "full"
                        and "ms" in c)
        if name == "probe_exp_dtype":
            return next(c for c in cases if c["kernel"] == name and c["L"] == 2048 and c.get("exp_bf16") is True
                        and c.get("mask") == "ones" and "ms" in c)
        if name == "packed_band":
            return next(c for c in cases if c["kernel"] == name and "ms" in c)
        L = PACKED_S if name.startswith("packed") else 2048
        return next(c for c in cases if c["kernel"] == name and c["dtype"] == "bf16" and c["L"] == L and "ms" in c)

    entries = []
    for name in ("flash_fwd", "flash_fwd_nomax", "fused_qkv", "fused_mlp", "flash_bwd_dq", "flash_bwd_dkv",
                 "packed_fwd", "packed_fwd_nomax", "packed_band", "packed_bwd_dq", "packed_bwd_dkv", "probe_variant",
                 "probe_exp_dtype"):
        c = entry_case(name)
        entries.append({
            "name": name, "route": "cuda", "source": SOURCE[name], "replaces": REPLACES[name],
            "launches": sum(counts[name] for counts in by_phase.values()),
            "launches_by_phase": {ph: counts[name] for ph, counts in by_phase.items()},
            "max_abs_err": c["max_abs_err"], "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "shape": {k: c[k] for k in ("B", "H", "L", "D", "F", "O", "Fh") if k in c}, "dtype": c["dtype"],
            **({"sfu_bound_ms": c["sfu_bound_ms"]} if "sfu_bound_ms" in c else {}),
        })
        fp32 = [c for c in cases if c["kernel"] == name and c.get("dtype") == "fp32" and "ms" in c
                and (c.get("L"), c.get("D")) in ((640, 16), (2048, 64), (PACKED_S, 64))]
        if fp32:  # the fp32 builds: PF's (32, 640, 4, 16), SR's (10, 2048, 4, 64), the packed (8, 5120, 4, 64)
            entries[-1]["fp32"] = [{k: c.get(k) for k in (
                "B", "H", "L", "D", "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "bound_term", "fma_bound_ms", "sfu_bound_ms")} for c in fp32]
        if name in ("fused_qkv", "fused_mlp"):  # the packed sampler's instance: per-segment rows at (80, 5120)
            c = next(c for c in cases if c["kernel"] == name and c["dtype"] == "bf16" and c["rows"] == "segment")
            entries[-1]["segment_rows"] = {k: c[k] for k in ("B", "L", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                                             "bound_by", "matmul_yardstick_ms")}
    missing = [e["name"] for e in entries if e["launches"] == 0]
    if missing and not (args.skip_serve or args.skip_train):
        fail(f"kernel(s) never launched on their main path: {missing}")
    emit({"phase": "total", "seconds": round(time.time() - t_start, 1)})
    print(smi, flush=True)
    emit({"kernels": entries})
    if args.skip_serve or args.skip_train:
        fail("--skip-serve/--skip-train: a main path was not driven, so no ok line")
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
