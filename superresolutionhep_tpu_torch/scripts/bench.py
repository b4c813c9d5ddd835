"""Benchmark harness: SR ensemble-inference throughput (events/s per card).

Counterpart of the JAX package's ``bench.py``, with its workload, its
``BENCH_*`` environment variables (and a flag beside each), and its two
lines: the production sampler settings of the reference deployment
(``configs/multipart/inference_batch.yml``: ``n_steps`` 25, 10 members,
``ab2e``) over 256 multipart-shaped synthetic events
(``GeneratorConfig(res_factor=4, max_particles=4, window_lr_cells=2)``, seed
42, ~1.2-4.8k HR cells an event), through the port's pipeline: host
preprocessing -> bucketed padded batches (or segment-packed rows with
``BENCH_PACKED=1``) -> ``flow/sampling.py::generate_ensemble`` on the
multipart ``FlowModel`` in bf16 (weights from seed 0 in the JAX layout, cast
once), no-max attention (K2, or K7 on packed rows) with the fused DiT layer
kernels (K3/K4) behind the first batch's no-max self-check against the
robust model (K1 / K7).  The sampler runs eagerly: nothing is compiled or
captured.

The events are made in memory (the JAX bench writes them to an HDF5 file
first).  Each batch shape is warmed twice, then each batch runs
``BENCH_REPS`` times (3) and is scored by its median; ``events_per_sec`` =
events / sum of the medians.  Noise: a ``torch.Generator`` per (batch, rep),
seeded ``KEY_SEED + 1 + i * 1024 + r`` (the JAX bench's ``fold_in(key, i *
1024 + r)``); the warm-up calls draw from ``KEY_SEED``.

Flops (``tools/flops.py``, the JAX bench's counts, the same numbers): the
model's padded and mask-discounted matmul flops, on packed rows under the
TPU kernel's band accounting at ``PACKED_DEFAULTS``' blocks (256 here).
They are not the work the Hopper kernels execute, which walk each tile's
exact band.  The MFU fields divide by this card's measured bf16 matmul rate
(``measured_chip_tfs``: 50 chained 4096^2 products in one CUDA graph), the
``*_vs_published_peak`` fields by the H100's published 989 TFLOP/s dense
bf16 rate, which assumes the full 700 W power limit (the detail line carries
the card's name and power limit).

Secondary figures (not on the CPU): the TPU golden (``closure_sr``'s no-max
fused bf16 sampler against ``tests/golden/sr_tpu_golden.npz`` with the JAX
noise of ``tests/golden_torch/sr_golden_x0.npz``, ``ok`` by max |diff| <=
3e-2, a reading), PF inference at (64, 2048) (``pf_bench``), the PF train
step at (25, 2048) and SR train steps at (8, 2048) and (6, 3584)
(``BENCH_TRAIN_VARIANTS=1`` adds the fused and no-remat legs).  An error in
one is recorded in its field.

    python -m superresolutionhep_tpu_torch.scripts.bench [--packed 1] [--reps 3] [--profile DIR] [--device cuda]

Prints the card's name and power limit, then, last on stdout, ``{"metric",
"value", "unit", "vs_baseline"}``; the detail goes to stderr.  ``--device
cpu`` is the JAX bench's degraded mode (16 events of a smaller generator, 5
steps, 2 members, no secondaries, ``"degraded": "cpu-backend"``) on the
tools' CPU model (``scripts/common.py::tiny_config_mv``); a card is never
replaced by the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..configs import (CLOSURE_SR_CONFIG_MV, CLOSURE_SR_CONFIG_T, CLOSURE_SR_DIR, MULTIPART_CONFIG_MV, PF_CONFIG_MV,
                       serve_inference_config)
from ..data.bucketing import BucketBatcher
from ..data.packing import aligned_len, collate_packed, pack_events
from ..data.sr_dataset import MODEL_BATCH_KEYS, collate
from ..flow.sampling import generate_ensemble, generate_samples
from ..inference.pf import pf_batch_to_device
from ..inference.sr import PACKED_BATCH_KEYS, SRInference, batch_to_device
from ..losses.set2set import set_to_set_incidence_loss
from ..models.flow_model import FlowModel
from ..models.pf import SAPF
from ..models.precision import cast_params_for_inference
from ..ops.flash_attention import nomax_selfcheck
from ..ops.flash_packed import PACKED_DEFAULTS, set_packed_defaults
from ..tools.convert import init_pf_params_jax_layout, pf_params_from_jax
from ..tools.flops import flow_model_flops, flow_model_flops_packed, sampler_evals, train_step_flops
from ..tools.profile_inference import random_model
from ..tools.trace_summary import ProfiledWindow
from ..train.pf_trainer import PFTrainer
from ..train.sr_trainer import SRTrainer
from ..transforms import build_var_transforms
from . import REPO_ROOT
from .bench_packed_train import GEN, SEED, bench_events
from .common import H100_FLOPS, device_line, graph_ms, measure_device, sync, tiny_config_mv

N_STEPS = 25
N_ENSEMBLE = 10
N_EVENTS = 256
METHOD = "ab2e"  # 2nd-order multistep, Euler bootstrap: n_steps - 1 evaluations (flow/ode.py)
KEY_SEED = 1  # the JAX bench's PRNGKey(1)
COST_BUDGET = 4096 * 4096 * 16
# the JAX bench's degraded CPU mode
DEGRADED = {"n_steps": 5, "n_ensemble": 2, "n_events": 16, "gen": dict(res_factor=4, max_particles=2, window_lr_cells=1)}
# the card's bf16 matmul rate: CHIP_CHAIN chained CHIP_N^2 products in one CUDA graph
CHIP_N, CHIP_CHAIN = 4096, 50
PUBLISHED_PEAK_TFS = H100_FLOPS[torch.bfloat16] / 1e12  # H100 SXM, dense bf16, at 700 W
TPU_GOLDEN_TOL = 3e-2  # the JAX golden check's bound: max |diff| in sample space
GOLDEN_DIR = os.path.join(REPO_ROOT, "tests", "golden")
GOLDEN_X0 = os.path.join(REPO_ROOT, "tests", "golden_torch", "sr_golden_x0.npz")
METRIC = f"sr_inference_events_per_sec_per_chip_nsteps{N_STEPS}_ens{N_ENSEMBLE}"


def _on(v: str) -> bool:
    return v != "0"


def _opt_int(v):
    return int(v) if v else None


# name: (the JAX bench's environment variable, its default, how it reads);
# each has a flag --name beside it, which wins over the variable
SETTINGS = {
    "fast": ("BENCH_FAST", "1", _on),
    "fused": ("BENCH_FUSED", "1", _on),
    "quantum": ("BENCH_QUANTUM", "512", int),
    "fine_q": ("BENCH_FINE_Q", None, _opt_int),
    "fine_above": ("BENCH_FINE_ABOVE", "3072", int),
    "maxb": ("BENCH_MAXB", "64", int),
    "tail": ("BENCH_TAIL", "exact", str),
    "merge_tails": ("BENCH_MERGE_TAILS", "0", int),
    "packed": ("BENCH_PACKED", "0", _on),
    "pack_s": ("BENCH_PACK_S", "5120", int),
    "pack_rows": ("BENCH_PACK_ROWS", "12", int),
    "pack_block": ("BENCH_PACK_BLOCK", "256", int),
    "profile": ("BENCH_PROFILE", None, lambda v: v or None),
    "reps": ("BENCH_REPS", None, _opt_int),
    "tpu_golden": ("BENCH_TPU_GOLDEN", "1", _on),
    "train_variants": ("BENCH_TRAIN_VARIANTS", "0", _on),
}


def settings(flags=None, environ=None) -> dict:
    """The bench's settings: each flag given, else its ``BENCH_*``
    variable, else the JAX bench's default."""
    flags, environ = flags or {}, os.environ if environ is None else environ
    out = {}
    for name, (var, default, read) in SETTINGS.items():
        raw = flags.get(name)
        out[name] = read(str(raw) if raw is not None else environ.get(var, default) or "")
    return out


# ---------------------------------------------------------------------------
# the pieces the headline and the secondaries share
# ---------------------------------------------------------------------------


def chip_tfs(dev) -> float:
    """The card's bf16 matmul rate in TFLOP/s: ``CHIP_CHAIN`` chained
    ``CHIP_N``^2 products (each reads the last one's output) captured in one
    CUDA graph (``common.graph_ms``)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    w = (torch.randn((CHIP_N, CHIP_N), generator=gen, device=dev) / CHIP_N ** 0.5).to(torch.bfloat16)
    bufs = [torch.randn((CHIP_N, CHIP_N), generator=gen, device=dev).to(torch.bfloat16), torch.empty_like(w)]
    turn = [0]

    def product():
        torch.matmul(bufs[turn[0]], w, out=bufs[1 - turn[0]])
        turn[0] = 1 - turn[0]

    ms = graph_ms(product, reps=10, chain=CHIP_CHAIN)
    return 2.0 * CHIP_N ** 3 / (ms * 1e-3) / 1e12


def _share(tfs, peak):
    return None if tfs is None or not peak else tfs / peak


def bench_model(config_mv, dev, fast=True, fused=True):
    """The bench's ``FlowModel``: bf16 compute, weights from seed 0 in the
    JAX layout cast to bf16 once (the geometry embedder kept fp32), no-max
    attention when ``fast``, the fused DiT layer kernels when ``fused``; and
    the robust model (running-max attention, unfused) on the same tensors."""
    model = random_model(config_mv, dev, attn_impl="flash_nomax" if fast else "auto", fused_prologue=fused,
                         dtype=torch.bfloat16)
    cast_params_for_inference(model)
    robust = FlowModel(config_mv["flow_model"], dtype=torch.bfloat16)
    robust.load_state_dict(model.state_dict(), assign=True)
    return model, robust.to(dev).eval().requires_grad_(False)


def bucketed_batches(ds, s):
    """The bucketed plan with the bench's settings: [(host batch, real
    events, their cell counts)] and the batcher."""
    batcher = BucketBatcher(ds.cell_count_high, quantum=s["quantum"], fine_quantum=s["fine_q"],
                            fine_above=s["fine_above"], cost_budget=COST_BUDGET, max_batch_size=s["maxb"],
                            shuffle=False, tail_shrink=s["tail"], merge_tail_up=s["merge_tails"])
    out = []
    for idxs, bucket in batcher:
        hb = collate([ds.get_event(i) if i >= 0 else None for i in idxs], bucket.pad_n)
        out.append((hb, int((idxs >= 0).sum()), [int(ds.cell_count_high[i]) for i in idxs if i >= 0]))
    return out, batcher


def packed_batches(ds, s):
    """Segment-packed rows (``pack_s`` x ``pack_rows`` a batch), the packed
    defaults set as the JAX bench sets them (blocks ``pack_block``, segments
    up to the longest event aligned to 128): [(host batch, events, their
    cell counts)].  The caller restores ``PACKED_DEFAULTS``."""
    counts = ds.cell_count_high
    set_packed_defaults(block_q=s["pack_block"], block_k=s["pack_block"],
                        max_segment_len=aligned_len(int(max(counts))))
    out = []
    for lay in pack_events(counts, S=s["pack_s"], rows_per_batch=s["pack_rows"]):
        hb = collate_packed({i: ds.get_event(i) for row in lay.rows for i, _, _ in row}, lay, S=s["pack_s"])
        out.append((hb, lay.n_events, [n for row in lay.rows for (_, _, n) in row]))
    return out


def batch_flops(model, config_mv, hb, n_valid, packed):
    """(padded, masked, attention) flops of one model evaluation of a batch,
    the JAX bench's accounting: ``flow_model_flops`` of the padded batch, or
    on packed rows ``flow_model_flops_packed`` at ``PACKED_DEFAULTS``'
    blocks (the TPU kernel's band accounting)."""
    if packed:
        f = flow_model_flops_packed(model, config_mv, hb["seg"], PACKED_DEFAULTS["block_q"],
                                    PACKED_DEFAULTS["block_k"])
    else:
        B, N = hb["eta"].shape[:2]
        f = flow_model_flops(model, config_mv, B, N, n_valid=n_valid)
    return f["total"], f["total_masked"], f["attention"]


def sampler_call(model, batch, n_ensemble=N_ENSEMBLE, n_steps=N_STEPS, generator=None, x0=None):
    """One production sampler call: ``n_ensemble`` members, ``ab2e`` at
    ``n_steps`` points, the final samples (E, B, N, 1)."""
    return generate_ensemble(model, batch, n_ensemble=n_ensemble, n_steps=n_steps, method=METHOD, ret_seq=False,
                             generator=generator, x0=x0)


def selfcheck(robust, fast, batch):
    """The no-max gate on one batch (``ops/flash_attention.py::
    nomax_selfcheck``): one evaluation at t = 0.5 from x = 0 through the
    robust and the fast model.  Returns its verdict and the max |robust -
    fast| it was given (a reading; the gate's bound is 6e-2)."""
    x0 = torch.zeros_like(batch["e_proxy"])
    t0 = torch.full((batch["eta"].shape[0],), 0.5, dtype=torch.float32, device=x0.device)
    outs = []

    def kept(model):
        def apply(b):
            outs.append(model(b, x0, t0))
            return outs[-1]
        return apply

    ok = nomax_selfcheck(kept(robust), kept(fast), batch)
    return ok, float((outs[0].float() - outs[1].float()).abs().max())


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(int(seed))


# ---------------------------------------------------------------------------
# the secondaries
# ---------------------------------------------------------------------------


def golden_inputs(dev, name="sr_tpu_golden"):
    """A frozen SR golden's (``tests/golden/<name>.npz``) batch on ``dev``,
    its frozen samples, its valid mask and the JAX sampler's x0 for it; the
    golden's bytes must be those the x0 file was made from."""
    import hashlib

    path = os.path.join(GOLDEN_DIR, f"{name}.npz")
    x0s = np.load(GOLDEN_X0)
    with open(path, "rb") as fp:
        if hashlib.sha256(fp.read()).digest() != bytes(x0s[f"golden_sha256::{name}"]):
            raise ValueError(f"{path} is not the file {GOLDEN_X0} was made from")
    z = np.load(path)
    batch = {k: torch.from_numpy(z[f"batch::{k}"]).to(dev) for k in
             ("eta", "cosphi", "sinphi", "layer", "e_proxy", "q_mask")}
    return z, batch, torch.from_numpy(x0s[f"x0::{name}"]).to(dev), z["batch::q_mask"].astype(bool)


def tpu_golden_model(dev):
    """``closure_sr`` on the production path the golden was frozen from:
    ``SRInference``'s fast model with the serving settings (bf16, no-max
    attention, the fused DiT layer kernels)."""
    blob = os.path.join(REPO_ROOT, CLOSURE_SR_DIR, "params.msgpack")
    inf = SRInference(serve_inference_config(CLOSURE_SR_CONFIG_MV, CLOSURE_SR_CONFIG_T, checkpoint_path=blob,
                                             n_steps=N_STEPS), device=dev)
    return inf.model_fast


@torch.no_grad()
def tpu_golden_diffs(model, dev):
    """|sample - frozen sample| over the golden's valid cells, the model's
    samples drawn by the golden's sampler (``ab2e`` at 25 points) from the
    JAX noise."""
    z, batch, x0, mask = golden_inputs(dev)
    out = generate_samples(model, batch, n_steps=int(z["n_steps"]), method=bytes(z["method"]).decode(), x0=x0)
    sync(dev)
    return np.abs(out[..., 0].float().cpu().numpy() - z["expected"][..., 0])[mask]


def tpu_golden(dev, model=None) -> dict:
    """The JAX bench's TPU-golden report on the port's own check:
    ``ok`` = max |diff| <= ``TPU_GOLDEN_TOL`` (a reading: bf16 is chaotic on
    this checkpoint, ``ROADMAP.md`` C4), the max and 99th percentile."""
    import hashlib

    z = np.load(os.path.join(GOLDEN_DIR, "sr_tpu_golden.npz"))
    with open(os.path.join(REPO_ROOT, CLOSURE_SR_DIR, "params.msgpack"), "rb") as fp:
        if hashlib.sha256(fp.read()).digest() != bytes(z["params_sha256"]):
            return {"ok": False, "reason": "checkpoint SHA changed"}
    d = tpu_golden_diffs(model if model is not None else tpu_golden_model(dev), dev)
    return {"ok": bool(d.max() <= TPU_GOLDEN_TOL), "max_diff": float(d.max()), "p99_diff": float(np.percentile(d, 99)),
            "tol": TPU_GOLDEN_TOL}


def pf_bench_batch(B, N, P, rng=None):
    """``_pf_bench``'s host batch, drawn from ``np.random.default_rng(0)``
    in the JAX bench's order."""
    rng = np.random.default_rng(0) if rng is None else rng
    z = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return {
        "cell_e": z(B, N), "cell_eta": z(B, N), "cell_phi": z(B, N),
        "cell_cosphi": z(B, N), "cell_sinphi": z(B, N),
        "cell_e_raw": np.abs(z(B, N)) * 20, "cell_eta_raw": z(B, N),
        "cell_layer": rng.integers(0, 3, (B, N)).astype(np.int32),
        "cell_mask": np.ones((B, N), bool),
        "part_pt": z(B, P), "part_eta": z(B, P), "part_phi": z(B, P),
        "part_dep_e": z(B, P), "part_mask": np.ones((B, P), bool),
        "incidence_matrix": np.abs(z(B, N, P)),
    }


def pf_model(cfg, dev, fused=True, params=None, attn_impl="auto"):
    """``SAPF(inference=True)`` of ``cfg``, fp32, weights from seed 0 in the
    JAX layout (or ``params``, a reference-layout state dict).  At the
    published h 64 the fused prologue's gate (F a multiple of 128) takes the
    unfused layer, as the JAX package's does."""
    model = SAPF(cfg["pf_model"], transforms=build_var_transforms(cfg["var_transform"]), inference=True,
                 fused_prologue=fused, attn_impl=attn_impl)
    if params is None:
        params = pf_params_from_jax(init_pf_params_jax_layout(cfg["pf_model"], seed=0), cfg["pf_model"])
    model.load_reference_state_dict(params)
    return model.to(dev).eval().requires_grad_(False)


@torch.no_grad()
def pf_forward(model, batch):
    """The PF inference hot path: forward, then the on-device matching of
    ``set_to_set_incidence_loss``: (argmax cardinality, kinematics, assignment)."""
    logits, kin, inc = model(batch)
    _, _, assign = set_to_set_incidence_loss(inc, batch, kin)
    return torch.argmax(logits, -1), kin, assign


def pf_bench(dev, B=64, N=2048, n_rep=10, fused=True, cfg=PF_CONFIG_MV, checked=contextlib.nullcontext):
    """Stage-2 throughput (``_pf_bench``): events/s of ``pf_forward`` at
    (B, N), after one warm call; one more call runs under ``checked()``."""
    model = pf_model(cfg, dev, fused=fused)
    batch = pf_batch_to_device(pf_bench_batch(B, N, int(cfg["pf_model"]["max_particles"])), dev)
    pf_forward(model, batch)
    sync(dev)
    with checked():
        pf_forward(model, batch)
    t0 = time.time()
    for _ in range(n_rep):
        pf_forward(model, batch)
    sync(dev)
    return round(B / ((time.time() - t0) / n_rep), 1)


def _timed_blocks(step, n_rep, dev):
    """Two warm steps, then 3 timed blocks of ``n_rep`` steps: the median block's seconds a step."""
    for _ in range(2):
        float(step()["loss"])
    blocks = []
    for _ in range(3):
        t0 = time.time()
        for _ in range(n_rep):
            st = step()
        float(st["loss"])
        sync(dev)
        blocks.append((time.time() - t0) / n_rep)
    return sorted(blocks)[1]


def pf_train_host_batch(B, N, P):
    """``_pf_train_bench``'s host batch, drawn from ``np.random.default_rng(0)``
    in the JAX bench's order."""
    rng = np.random.default_rng(0)
    z = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    inc = np.abs(z(B, N, P)) + 1e-3
    inc = inc / inc.sum(-1, keepdims=True)
    return {
        "cell_e": z(B, N), "cell_eta": z(B, N), "cell_phi": z(B, N),
        "cell_cosphi": z(B, N), "cell_sinphi": z(B, N),
        "cell_e_raw": np.abs(z(B, N)) * 20, "cell_eta_raw": z(B, N),
        "cell_layer": rng.integers(0, 3, (B, N)).astype(np.int32),
        "cell_mask": np.ones((B, N), bool),
        "part_pt": z(B, P), "part_eta": z(B, P), "part_phi": z(B, P),
        "part_dep_e": np.abs(z(B, P)) * 10,
        "part_mask": np.ones((B, P), bool),
        "cardinality": np.full((B,), P, np.int32),
        "incidence_matrix": inc.astype(np.float32),
    }


def pf_train_config(N):
    """``_pf_train_bench``'s training settings."""
    return {"num_epochs": 1, "learningrate": 1e-3, "lr_scheduler": None, "loss_on_inc_wts": True,
            "card_loss_weight": 0.5, "grad_clip_norm": 1.0, "bucket_quantum": N}


def pf_train_bench(dev, B=25, N=2048, n_rep=8, cfg=PF_CONFIG_MV, checked=contextlib.nullcontext):
    """Stage-2 training-step throughput (``_pf_train_bench``): SAPF forward
    and backward (K1/K5/K6 fp32), the matching inside the incidence loss,
    the clip at 1.0 and AdamW at the reference packer scale; then one
    ``loss_and_grads`` under ``checked()``."""
    P = int(cfg["pf_model"]["max_particles"])
    with tempfile.TemporaryDirectory() as td:
        trainer = PFTrainer(cfg, pf_train_config(N), run_dir=td, device=dev)
    batch = pf_batch_to_device(pf_train_host_batch(B, N, P), dev)
    dt = _timed_blocks(lambda: trainer.train_step(batch, lr=1e-3), n_rep, dev)
    with checked():
        trainer.loss_and_grads(batch)
    return {"steps_per_sec": round(1.0 / dt, 2), "events_per_sec": round(B / dt, 1), "batch": [B, N]}


def sr_train_host_batch(B, N):
    """``_train_bench``'s host batch, drawn from ``np.random.default_rng(0)``
    in the JAX bench's order."""
    rng = np.random.default_rng(0)
    return {
        "eta": rng.normal(size=(B, N, 1)).astype(np.float32),
        "cosphi": rng.normal(size=(B, N, 1)).astype(np.float32),
        "sinphi": rng.normal(size=(B, N, 1)).astype(np.float32),
        "layer": rng.integers(0, 3, size=(B, N, 1)).astype(np.int32),
        "e_proxy": rng.normal(size=(B, N, 1)).astype(np.float32),
        "q_mask": np.ones((B, N), bool),
        "target": rng.normal(size=(B, N, 1)).astype(np.float32),
    }


def sr_train_config(N, fused, remat):
    """``_train_bench``'s training settings."""
    return {"num_epochs": 1, "learningrate": 1e-3, "lr_scheduler": None, "remat": remat, "bucket_quantum": N,
            "fused_prologue": fused}


def train_bench(dev, config_mv, B=8, N=2048, n_rep=8, fused=False, remat=True, peak_tfs=None,
                checked=contextlib.nullcontext):
    """SR training-step throughput (``_train_bench``): forward, backward and
    AdamW at multipart scale, bf16 compute on fp32 parameters, per-layer
    remat and the fused DiT layer kernels as given; the executed-flop MFU
    (``tools/flops.py::train_step_flops``: remat's recompute is real work)
    beside the useful-flop rate.  One ``loss_and_grads`` after the timed
    blocks runs under ``checked()``."""
    with tempfile.TemporaryDirectory() as td:
        trainer = SRTrainer(config_mv, sr_train_config(N, fused, remat), run_dir=td, dtype=torch.bfloat16,
                            device=dev)
    batch = trainer._device_batch(sr_train_host_batch(B, N))
    dt = _timed_blocks(lambda: trainer.train_step(batch, lr=1e-3), n_rep, dev)
    with checked():
        trainer.loss_and_grads(batch)
    tf = train_step_flops(trainer.model, config_mv, B, N, remat=remat)
    executed, useful = tf["total"] / dt / 1e12, tf["total_useful"] / dt / 1e12
    on_card = dev.type == "cuda"
    return {
        "steps_per_sec": round(1.0 / dt, 2),
        "events_per_sec": round(B / dt, 1),
        "batch": [B, N],
        "fused_prologue": fused,
        "remat": remat,
        "train_tfs_executed": round(executed, 1) if on_card else None,
        "train_tfs_useful": round(useful, 1) if on_card else None,
        "train_mfu": round(_share(executed, peak_tfs), 3) if peak_tfs else None,
        "train_mfu_useful": round(_share(useful, peak_tfs), 3) if peak_tfs else None,
        "train_mfu_vs_published_peak": executed / PUBLISHED_PEAK_TFS if on_card else None,
        "train_mfu_useful_vs_published_peak": useful / PUBLISHED_PEAK_TFS if on_card else None,
    }


def _recorded(fn, **leg):
    """``fn()``, or ``leg`` with the error it raised (a secondary never stops the run)."""
    try:
        return fn()
    except Exception as e:  # recorded in the result, as the JAX bench does
        print(json.dumps({"error": f"{type(e).__name__}: {e}"[:200], **leg}), file=sys.stderr, flush=True)
        return dict(leg, error=f"{type(e).__name__}: {e}"[:200])


SR_TRAIN_LEGS = [dict(B=8, N=2048), dict(B=6, N=3584)]  # the multipart bucket top end: the packer cap 3520 -> 3584
SR_TRAIN_VARIANTS = [dict(B=8, N=2048, fused=True), dict(B=8, N=2048, remat=False), dict(B=6, N=3584, fused=True)]


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------


@torch.no_grad()
def _infer_pass(model, batches, dev, n_ensemble, n_steps, reps):
    per_batch, medians, raw = [], [], 0.0
    for i, (mb, n_real, _) in enumerate(batches):
        times = []
        for r in range(reps):
            tb = time.time()
            sampler_call(model, mb, n_ensemble, n_steps, generator=_gen(dev, KEY_SEED + 1 + i * 1024 + r))
            sync(dev)
            times.append(time.time() - tb)
        medians.append(float(np.median(times)))
        raw += sum(times)
        per_batch.append((tuple(mb["eta"].shape[:2]), n_real, [round(t, 3) for t in times]))
    return per_batch, medians, raw


@torch.no_grad()
def _warm(model, batches, dev, n_ensemble, n_steps):
    seen = []
    for mb, _, _ in batches:
        shape = tuple(mb["eta"].shape)
        if shape not in seen:
            seen.append(shape)
            tc = time.time()
            for _ in range(2):
                sampler_call(model, mb, n_ensemble, n_steps, generator=_gen(dev, KEY_SEED))
            sync(dev)
            print(f"warmed {shape}: {time.time() - tc:.1f}s", file=sys.stderr, flush=True)
    return seen


def bench(dev, s=None, n_events=None, config_mv=None, secondaries=True, train_n_rep=8, pf_n_rep=10,
          checked=contextlib.nullcontext, windows=None):
    """The JAX bench's run on ``dev`` with the settings ``s`` (``settings()``).
    Returns (the headline line, the detail).  ``n_events``, ``train_n_rep``
    and ``pf_n_rep`` cut the workload (``chip_smoke.py``'s bench phase);
    ``secondaries`` off skips the figures after the headline (the TPU
    golden too);
    ``checked()`` (a context-manager factory) wraps the self-check and one
    call of each secondary's kernel path; ``windows`` collects the profiled
    window."""
    s = settings() if s is None else s
    degraded = dev.type == "cpu"
    n_steps, n_ens = (DEGRADED["n_steps"], DEGRADED["n_ensemble"]) if degraded else (N_STEPS, N_ENSEMBLE)
    if degraded:
        print("[bench] CPU: degraded mode (16 events, 2 x 5 evaluations, the tools' CPU model); metric labeled "
              "accordingly", file=sys.stderr, flush=True)
        n_events, gen = n_events or DEGRADED["n_events"], DEGRADED["gen"]
        config_mv = config_mv or tiny_config_mv()
    else:
        n_events, gen = n_events or N_EVENTS, GEN
        config_mv = config_mv or MULTIPART_CONFIG_MV
    fast = s["fast"]
    fused = fast and s["fused"]
    packed = s["packed"]
    reps = s["reps"] or (1 if degraded else 3)

    ds = bench_events(config_mv, n_events, gen, SEED)
    model, robust = bench_model(config_mv, dev, fast=fast, fused=fused)
    saved = dict(PACKED_DEFAULTS)
    try:
        t_prep = time.time()
        if packed:
            host = packed_batches(ds, s)
            keys, buckets = PACKED_BATCH_KEYS, [("packed", s["pack_rows"], s["pack_s"])]
        else:
            host, batcher = bucketed_batches(ds, s)
            keys, buckets = MODEL_BATCH_KEYS, [(int(b.pad_n), int(b.batch_size)) for b in batcher.buckets]
        batches = [(batch_to_device(hb, dev, keys), n_real, nv) for hb, n_real, nv in host]
        sync(dev)
        host_prep_s = time.time() - t_prep

        shapes = _warm(model, batches, dev, n_ens, n_steps)
        nomax_ok = nomax_diff = None
        if fast:
            with checked():
                nomax_ok, nomax_diff = selfcheck(robust, model, batches[0][0])
            print(f"nomax selfcheck: {'OK' if nomax_ok else 'FAILED'} (max |robust - fast| {nomax_diff:.4g})",
                  file=sys.stderr, flush=True)
            if not nomax_ok:
                # production semantics (inference/sr.py): the robust model
                # samples; no throughput from a kernel that failed its gate
                fast, model = False, robust
                _warm(model, batches, dev, n_ens, n_steps)

        evals = sampler_evals(n_steps, METHOD) * n_ens
        flops = [tuple(f * evals for f in batch_flops(model, config_mv, hb, nv, packed)) for hb, _, nv in host]
    finally:
        set_packed_defaults(**saved)

    window = None
    if s["profile"]:
        window = ProfiledWindow(dev, "bench timed pass", trace_path=os.path.join(s["profile"], "bench_trace.json"))
    with window or contextlib.nullcontext():
        per_batch, medians, wall_raw = _infer_pass(model, batches, dev, n_ens, n_steps, reps)
    if window is not None and windows is not None:
        windows.append(window)

    dt = sum(medians)
    total_events = sum(n for _, n, _ in batches)
    lat = np.asarray([m for m, (_, n, _) in zip(medians, batches) for _ in range(n)])
    total_flops, total_masked, total_attn = (sum(f[j] for f in flops) for j in range(3))
    peak = None if degraded else chip_tfs(dev)
    achieved = None if degraded else total_flops / dt / 1e12
    achieved_masked = None if degraded else total_masked / dt / 1e12
    events_per_sec = total_events / dt

    published = {}
    try:
        with open(os.path.join(REPO_ROOT, "BASELINE.json")) as fp:
            published = json.load(fp).get("published", {}) or {}
    except (OSError, ValueError):
        pass
    base = published.get("sr_inference_events_per_sec")
    vs = events_per_sec / base if (base and not degraded) else None

    golden = None
    if not degraded and secondaries and s["tpu_golden"]:
        golden = _recorded(lambda: tpu_golden(dev))
        if "error" in golden:
            golden = {"ok": None, "reason": golden["error"], "error": golden["error"]}
        print(json.dumps({"tpu_golden": golden}), file=sys.stderr, flush=True)

    pf_eps = pf_train = sr_train = None
    if not degraded and secondaries:
        pf_eps = _recorded(lambda: pf_bench(dev, n_rep=pf_n_rep, fused=s["fused"], checked=checked))
        pf_train = _recorded(lambda: pf_train_bench(dev, n_rep=train_n_rep, checked=checked))
        legs = SR_TRAIN_LEGS + (SR_TRAIN_VARIANTS if s["train_variants"] else [])
        sr_train = [_recorded(lambda: train_bench(dev, config_mv, n_rep=train_n_rep, peak_tfs=peak,
                                                  checked=checked, **leg), **leg) for leg in legs]

    result = {"metric": METRIC, "value": round(events_per_sec, 3), "unit": "events/s",
              "vs_baseline": round(vs, 3) if vs else None}
    if degraded:
        result["degraded"] = "cpu-backend"
    detail = {
        "device": str(dev),
        "card": device_line(dev),
        "n_events": total_events,
        "wall_s": round(dt, 3),
        "wall_raw_s": round(wall_raw, 3),
        "reps_per_batch": reps,
        "host_prep_s": round(host_prep_s, 3),
        # an event's latency is the wall time of the batch that carried it
        "p50_event_latency_ms": round(1000.0 * float(np.percentile(lat, 50)), 2),
        "p95_event_latency_ms": round(1000.0 * float(np.percentile(lat, 95)), 2),
        "mean_event_cost_ms": round(1000.0 * dt / max(total_events, 1), 2),
        # tools/flops.py: padded = the model's matmuls on the padded batch
        # (packed rows: the TPU kernel's band at PACKED_DEFAULTS' blocks);
        # masked discounts pad cells; not the Hopper kernels' executed work
        "achieved_tfs": round(achieved, 1) if achieved is not None else None,
        "achieved_tfs_masked": round(achieved_masked, 1) if achieved_masked is not None else None,
        "measured_chip_tfs": peak,
        "published_peak_tfs": PUBLISHED_PEAK_TFS,
        "mfu_vs_measured_chip_peak": round(_share(achieved, peak), 3) if peak else None,
        "mfu_masked_vs_measured_chip_peak": round(_share(achieved_masked, peak), 3) if peak else None,
        "mfu_vs_published_peak": _share(achieved, PUBLISHED_PEAK_TFS),
        "mfu_masked_vs_published_peak": _share(achieved_masked, PUBLISHED_PEAK_TFS),
        "attention_flop_share": round(total_attn / total_flops, 3),
        "fast_softmax": fast,
        "nomax_selfcheck_ok": nomax_ok,
        "nomax_selfcheck_max_abs_diff": nomax_diff,
        "padding_flop_overhead": round(total_flops / total_masked - 1.0, 3),
        "packed": packed,
        "buckets": buckets,
        "n_shapes": len(shapes),
        "per_batch": per_batch,
        "profile": ({**window.record(), "trace": window.trace_path} if window is not None and dev.type == "cuda"
                    else None),
        "tpu_golden": golden,
        "pf_inference_events_per_sec": pf_eps,
        "pf_train": pf_train,
        "sr_train": sr_train,
    }
    return result, detail


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    for name, (var, default, _) in SETTINGS.items():
        ap.add_argument("--" + name.replace("_", "-"), default=None, help=f"as {var} (default {default})")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from ..utils.hostmem import ensure_tuned

    ensure_tuned()  # glibc malloc tunables, by one re-exec of this command
    dev = measure_device(args.device)
    s = settings({k: getattr(args, k) for k in SETTINGS})
    print(device_line(dev), flush=True)
    result, detail = bench(dev, s)
    print(json.dumps(result), flush=True)
    print(json.dumps({"detail": detail}), file=sys.stderr, flush=True)
    return result, detail


if __name__ == "__main__":
    main()
