"""Analytic FLOP accounting for the SR flow model.

The port's counterpart of the JAX package's ``tools/flops.py``, the
yardstick of a benchmark's model-FLOP utilisation.  A profiler's count of the
hand-written kernels sees nothing inside them, so the forward FLOPs are
counted from the model:
  * every ``nn.Linear`` of the ``FlowModel`` contributes ``2 * d_in * d_out``
    per applied position (multiply + add), classified as per-cell (applied at
    each of the B*N padded positions) or per-event (the timestep embedder and
    the adaLN modulation nets, applied once per event) by its name in the
    module tree, which keeps the JAX parameter paths' markers
    (``time_step_embedder``, ``adaLN``; tools/convert.py);
  * the attention score and value matmuls contribute
    ``2 * B * H * Lq * Lk * D`` each per transformer layer (what the flash
    kernels compute);
  * both a padded count (what the card executes on the padded batch) and a
    mask-discounted count (attention scaled by sum(n_i^2)/(B N^2), linears by
    sum(n_i)/(B N)) are reported; the gap is the padding overhead.

Elementwise work (norms, activations, softmax) is excluded: it is
bandwidth-, not FLOP-bound, and MFU is a matmul-utilization metric.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

# module-name fragments applied once per EVENT (every other nn.Linear runs per
# cell): timestep embedder MLP, adaLN modulation nets (context -> shifts /
# scales / gates), final v_t modulation
_PER_EVENT_MARKERS = ("time_step_embedder", "adaLN", "adaln")


def _iter_linears(model: nn.Module):
    for name, mod in model.named_modules():
        if isinstance(mod, nn.Linear):
            yield name, int(mod.in_features), int(mod.out_features)


def flow_model_flops(
    model: nn.Module,
    config_mv: dict,
    B: int,
    N: int,
    n_valid: Optional[Sequence[int]] = None,
) -> Dict[str, float]:
    """Forward FLOPs of ONE FlowModel evaluation on a (B, N) padded batch.

    ``model``: the ``FlowModel``.  ``n_valid``: real cell counts of the events
    in the batch; when given, ``*_masked`` entries discount padding.
    Returns a dict with ``linear``, ``attention``, ``total`` (padded) and the
    ``*_masked`` variants.
    """
    per_cell = 0.0  # FLOPs per (event, cell) position
    per_event = 0.0  # FLOPs per event
    for path, d_in, d_out in _iter_linears(model):
        flops = 2.0 * d_in * d_out
        if any(m in path for m in _PER_EVENT_MARKERS):
            per_event += flops
        else:
            per_cell += flops

    fm = config_mv["flow_model"]
    n_layers = int(fm["transformer"]["num_transformer_layers"])
    h_dim = int(fm["h_dim"])  # H * D == h_dim in this architecture
    # score (QK^T) + value (PV) matmuls: 2 * (2 * B * N^2 * H * D) per layer
    attn = n_layers * 4.0 * B * float(N) ** 2 * h_dim

    linear = B * N * per_cell + B * per_event
    out = {
        "linear": linear,
        "attention": attn,
        "total": linear + attn,
    }
    if n_valid is not None:
        nv = np.asarray(list(n_valid), np.float64)
        cell_frac = float(nv.sum()) / (B * N)
        attn_frac = float((nv**2).sum()) / (B * float(N) ** 2)
        out["linear_masked"] = B * N * per_cell * cell_frac + B * per_event
        out["attention_masked"] = attn * attn_frac
        out["total_masked"] = out["linear_masked"] + out["attention_masked"]
    return out


def flow_model_flops_packed(
    model: nn.Module,
    config_mv: dict,
    seg: np.ndarray,
    block_q: int,
    block_k: int,
) -> Dict[str, float]:
    """Forward FLOPs of ONE FlowModel evaluation on a segment-packed (B, S)
    batch (ops/flash_packed.py).

    Differences vs the bucketed count: attention executes only the banded
    (block_q, block_k) blocks, from the port's band table (the plain version
    of ``packed_band``); the adaLN modulation nets run per SEGMENT slot
    (E = S // SEG_ALIGN per row) with their outputs scattered per cell through
    a one-hot (S x E) matmul, and both the per-segment nets and the
    scatter/gather matmuls are counted.  Padding cells still execute the
    per-cell linears.  (The port gathers the per-segment rows where the JAX
    package multiplies by the one-hot matrix; the count keeps that matmul, so
    the two packages' counters agree.)
    """
    from ..ops.flash_packed import SEG_ALIGN, _ref_packed_band

    seg = np.asarray(seg)
    B, S = seg.shape
    E = S // SEG_ALIGN  # segment slots per row (flow_model.py packed path)

    per_cell = 0.0
    per_seg = 0.0  # adaLN modulation nets: once per segment slot
    per_row = 0.0  # timestep embedder: once per packed row
    scatter_d = 0.0  # one-hot scattered feature widths (per-cell 2*E*d each)
    ctx_d = 0.0  # context width (d_in of the modulation nets)
    for path, d_in, d_out in _iter_linears(model):
        flops = 2.0 * d_in * d_out
        if "time_step_embedder" in path:
            per_row += flops
        elif any(m in path for m in _PER_EVENT_MARKERS):
            per_seg += flops
            scatter_d += d_out  # per-cell scatter of the modulation output
            ctx_d = d_in  # context width (same for every modulation net)
        else:
            per_cell += flops
    if per_seg:
        scatter_d += ctx_d  # the ONE per-cell context gather (flow_model)
    per_cell += 2.0 * E * scatter_d  # one-hot (S x E) gather/scatter matmuls

    fm = config_mv["flow_model"]
    n_layers = int(fm["transformer"]["num_transformer_layers"])
    h_dim = int(fm["h_dim"])

    band = _ref_packed_band(torch.as_tensor(seg, dtype=torch.int32), block_q, block_k)
    kcnt = band[..., 1].numpy()
    banded_pairs = float(np.asarray(kcnt, np.float64).sum()) * block_q * block_k
    attn = n_layers * 4.0 * h_dim * banded_pairs

    nv = np.asarray([(seg[b] == s).sum() for b in range(B)
                     for s in range(int(seg[b].max()) + 1 if (seg[b] >= 0).any() else 0)], np.float64)
    linear = B * S * per_cell + B * E * per_seg + B * per_row
    linear_masked = float(nv.sum()) * per_cell + len(nv) * per_seg + B * per_row
    attn_masked = n_layers * 4.0 * h_dim * float((nv**2).sum())
    return {
        "linear": linear,
        "attention": attn,
        "total": linear + attn,
        "linear_masked": linear_masked,
        "attention_masked": attn_masked,
        "total_masked": linear_masked + attn_masked,
    }


def train_step_flops(
    model: nn.Module,
    config_mv: dict,
    B: int,
    N: int,
    n_valid: Optional[Sequence[int]] = None,
    remat: bool = True,
) -> Dict[str, float]:
    """Matmul FLOPs of ONE fwd+bwd training step (AdamW update excluded:
    elementwise, consistent with this module's forward policy).

    Exact matmul counts for the training path (per DiT layer, in units of one
    attention matmul ``2*B*N^2*h_dim``):

      * attention forward: 2 (QK^T, PV);
      * attention backward: 7 — the dq kernel recomputes S then forms dP and
        dQ (3 matmuls); the dk/dv kernel recomputes S then forms dV, dP, dK
        (4 matmuls);
      * per-layer remat (``torch.utils.checkpoint`` of each DiT layer) re-runs
        the whole layer forward inside the backward: +2 attention matmuls.

      -> executed attention multiplier vs forward: 11/2 = 5.5 with remat,
         9/2 = 4.5 without.

    Linear layers: forward 1 matmul; backward dX = dY W^T and dW = X^T dY
    (2); remat recompute +1 -> 4x with remat, 3x without.  (Layers outside
    the remat'd DiT layers — embedders, final projection — execute 3x even
    with remat; they are a few % of linear FLOPs, counted at the layer
    multiplier for simplicity.)

    ``*_useful`` entries apply the standard no-recompute accounting (3x both
    classes) for hardware-independent comparisons; the executed (padded)
    count is what the card really runs, recomputes included.
    """
    f = flow_model_flops(model, config_mv, B, N, n_valid)
    lin_mult = 4.0 if remat else 3.0
    attn_mult = 5.5 if remat else 4.5
    out = {
        "linear": f["linear"] * lin_mult,
        "attention": f["attention"] * attn_mult,
        "linear_useful": f["linear"] * 3.0,
        "attention_useful": f["attention"] * 3.0,
    }
    out["total"] = out["linear"] + out["attention"]
    out["total_useful"] = out["linear_useful"] + out["attention_useful"]
    if n_valid is not None:
        out["linear_masked"] = f["linear_masked"] * lin_mult
        out["attention_masked"] = f["attention_masked"] * attn_mult
        out["total_masked"] = out["linear_masked"] + out["attention_masked"]
    return out


def sampler_evals(n_steps: int, method: str) -> int:
    """Model evaluations of one sampler run over a linspace(0,1,n_steps) grid.

    Fixed-step methods pay k evals per step; ab2/ab3 pay 1 per step after a
    Heun bootstrap (2 evals on the first interval), totalling exactly
    ``n_steps`` evals; ab2e's Euler bootstrap reuses f0, so it pays
    ``n_steps - 1`` (flow/ode.py)."""
    per_step = {"euler": 1, "midpoint": 2, "heun": 2, "rk4": 4}
    if method in ("ab2", "ab3"):
        return int(n_steps)  # Heun bootstrap (2) + 1 per remaining interval
    if method == "ab2e":
        return int(n_steps) - 1  # Euler bootstrap reuses f0
    if method in per_step:
        return per_step[method] * (int(n_steps) - 1)
    raise ValueError(f"eval count undefined for adaptive method {method!r}")
