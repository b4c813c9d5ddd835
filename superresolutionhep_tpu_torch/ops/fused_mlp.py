"""Fused DiT MLP half-layer: residuals, norms, modulation and both MLP
products in one hand-written CUDA kernel for Hopper (``csrc/fused_mlp.cu``).

Everything a DiT layer does AFTER the attention output projection:

    h  = q + gate_msa * attn_out                  # gated residual
    u  = LN(h) * eff_a + eff_b                    # norm2 + modulate, folded
    u2 = LN(u)                                    # Dense's pre-linear norm
    z  = leaky_relu(u2 @ W0 + b0)
    z2 = leaky_relu(z @ W1 + b1)
    q' = h + gate_mlp * z2                        # gated residual

with eff_a = gamma2 * (1 + scale), eff_b = beta2 * (1 + scale) + shift.
One kernel reads the q and attn_out tiles once, keeps every intermediate in
shared memory and registers, and writes the new q tile once.  The four
modulation rows come per batch row, per cell, or per segment with the
packed batch's ``segment_ids`` (the forms of ``ops/fused_qkv.py``).

Shape contract: the production DiT MLP exactly — one hidden layer,
pre-linear parameter-free LayerNorm, LeakyReLU(0.01) activations, no context
concat, dropout 0.  The caller gates on ``mlp_config_fusable``,
``fused_mlp_ok`` (the JAX package's rule) and ``fused_mlp_capacity_ok`` (what
the kernel is built for) and takes the standard path otherwise.
"""

from __future__ import annotations

import torch

from . import kernels
from .fused_qkv import KERNEL_WIDTHS, SMEM_LIMIT, _ln_noaffine, _recompute_vjp, cell_rows, kernel_rows, rows_mode

LRELU_SLOPE = 0.01  # torch default — models/dense.py ACTIVATIONS


def fused_mlp_ok(L: int, F: int, Fh: int) -> bool:
    return F % 128 == 0 and Fh % 128 == 0 and max(F, Fh) <= 1024 and L >= 128 and L % 128 == 0


def _lrelu(x):
    return torch.where(x >= 0, x, LRELU_SLOPE * x)


def _row3(r):
    """(B, F) row -> broadcastable (B, 1, F); per-cell (B, L, F) unchanged."""
    return r if r.ndim == 3 else r[:, None, :]


def _ref_dit_mlp(q, attn_out, gate_a, eff_a, eff_b, gate_m, w0, b0, w1, b1):
    """Plain version.  u2 and z are cast to the weight dtype before each
    product; everything else is fp32."""
    h = q.float() + _row3(gate_a).float() * attn_out.float()
    u = _ln_noaffine(h) * _row3(eff_a).float() + _row3(eff_b).float()
    u2 = _ln_noaffine(u)
    z = torch.matmul(u2.to(w0.dtype).float(), w0.float())
    z = _lrelu(z + b0.float()[None, None])
    z2 = torch.matmul(z.to(w1.dtype).float(), w1.float())
    z2 = _lrelu(z2 + b1.float()[None, None])
    return (h + _row3(gate_m).float() * z2).to(q.dtype)


def _ref_dit_mlp_rows(q, attn_out, gate_a, eff_a, eff_b, gate_m, w0, b0, w1, b1, segment_ids=None):
    """Plain version in any of the three row forms (a segment table is
    gathered per cell first), then ``_ref_dit_mlp``."""
    rows = (cell_rows(r, segment_ids) for r in (gate_a, eff_a, eff_b, gate_m))
    return _ref_dit_mlp(q, attn_out, *rows, w0, b0, w1, b1)


def kernel_smem_bytes(F: int, Fh: int, itemsize: int) -> int:
    """Dynamic shared memory of one block of csrc/fused_mlp.cu.  bf16 (the
    wgmma body; the hidden tile z stays in registers): 1 KB of alignment
    slack; for each of two 64-row warpgroups the fp32 residual h and the
    swizzled normalised tile (later the output staging tiles); a ring of two
    16 KB weight slabs and its four barriers.  fp32: the normalised tile, the
    hidden tile and two weight slabs of a 64-row block, each row padded by 16
    bytes."""
    if itemsize == 2:
        return 1024 + 2 * 64 * F * 4 + 2 * 64 * F * 2 + 2 * 128 * 64 * 2 + 2 * 2 * 8
    return 64 * ((F + 4) + (Fh + 4) + 2 * (128 + 4)) * 4


def fused_mlp_capacity_ok(F: int, Fh: int, dtype) -> bool:
    """Whether the kernel takes widths (F, Fh) in ``dtype``: widths the bf16
    body is built for, and a block that fits the card's shared memory.  The model consults it beside
    ``fused_mlp_ok`` and takes the unfused MLP where it fails, on every device
    alike."""
    if dtype == torch.bfloat16:
        return F in KERNEL_WIDTHS and Fh in KERNEL_WIDTHS and kernel_smem_bytes(F, Fh, 2) <= SMEM_LIMIT
    return (dtype == torch.float32 and F % 128 == 0 and Fh % 128 == 0
            and kernel_smem_bytes(F, Fh, 4) <= SMEM_LIMIT)


def _cuda_dit_mlp(q, attn_out, gate_a, eff_a, eff_b, gate_m, w0, b0, w1, b1, segment_ids=None):
    B, L, F = q.shape
    Fh = w0.shape[1]
    dev, dt = q.device, q.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_dit_mlp kernel takes bfloat16 or float32, got {dt}")
    if attn_out.shape != q.shape or attn_out.dtype != dt or attn_out.device != dev:
        raise ValueError("fused_dit_mlp: attn_out must match q in shape, dtype and device")
    for name, w, shape in (("w0", w0, (F, Fh)), ("w1", w1, (Fh, F))):
        if w.device != dev or w.dtype != dt or tuple(w.shape) != shape:
            raise ValueError(f"fused_dit_mlp: {name} must be {dt} {shape} on {dev}, got {w.dtype} {tuple(w.shape)}")
    if not fused_mlp_ok(L, F, Fh):
        raise ValueError(f"fused_dit_mlp: shape L={L}, F={F}, Fh={Fh} fails fused_mlp_ok")
    if not fused_mlp_capacity_ok(F, Fh, dt):
        raise ValueError(
            f"fused_dit_mlp: the kernel does not take F={F}, Fh={Fh} in {dt} "
            f"({kernel_smem_bytes(F, Fh, q.element_size())} bytes of shared memory a block, at most {SMEM_LIMIT}; "
            f"widths {KERNEL_WIDTHS} in bf16; fused_mlp_capacity_ok)"
        )
    mode, e1 = rows_mode(gate_a, B, L, segment_ids)
    for name, r in (("eff_a", eff_a), ("eff_b", eff_b), ("gate_m", gate_m)):
        if r.shape != gate_a.shape:
            raise ValueError(f"fused_dit_mlp: {name} must be {tuple(gate_a.shape)} as gate_a, got {tuple(r.shape)}")
    rows, seg = kernel_rows((gate_a, eff_a, eff_b, gate_m), dev, segment_ids)
    q = q.contiguous()
    attn_out = attn_out.contiguous()
    w0t = w0.t().contiguous()  # (Fh, F); no copy for the transposed view of a Linear weight
    w1t = w1.t().contiguous()  # (F, Fh)
    b0 = b0.reshape(-1).to(device=dev, dtype=torch.float32).contiguous()
    b1 = b1.reshape(-1).to(device=dev, dtype=torch.float32).contiguous()
    if b0.numel() != Fh or b1.numel() != F:
        raise ValueError("fused_dit_mlp: bias sizes do not match the weights")
    out = torch.empty_like(q)
    lib = kernels.library()
    with torch.cuda.device(dev):
        rc = lib.srhep_fused_mlp(
            q.data_ptr(), attn_out.data_ptr(),
            rows[0].data_ptr(), rows[1].data_ptr(), rows[2].data_ptr(), rows[3].data_ptr(),
            w0t.data_ptr(), b0.data_ptr(), w1t.data_ptr(), b1.data_ptr(),
            seg.data_ptr() if seg is not None else None, out.data_ptr(),
            B * L, L, F, Fh, mode, e1, kernel_smem_bytes(F, Fh, q.element_size()), int(dt == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    kernels.check(rc, "fused_mlp")
    kernels.LAUNCHES["fused_mlp"] += 1
    return out


class _FusedDitMlp(torch.autograd.Function):
    """Forward: the K4 kernel (the plain version on the CPU).  Backward: a
    recompute through ``_ref_dit_mlp_rows``, as the JAX package's custom VJP."""

    @staticmethod
    def forward(ctx, segment_ids, *args):
        ctx.save_for_backward(*args)
        ctx.segment_ids = segment_ids
        if args[0].is_cuda:
            return _cuda_dit_mlp(*args, segment_ids)
        return _ref_dit_mlp_rows(*args, segment_ids)

    @staticmethod
    def backward(ctx, g):
        def ref(*args):
            return _ref_dit_mlp_rows(*args, ctx.segment_ids)

        return (None, *_recompute_vjp(ref, ctx.saved_tensors, ctx.needs_input_grad[1:], g))


def fused_dit_mlp(q, attn_out, gate_a, eff_a, eff_b, gate_m, w0, b0, w1, b1, segment_ids=None):
    """One-pass DiT MLP half-layer (module docstring).  q/attn_out:
    (B, L, F); gate_a/eff_a/eff_b/gate_m: (B, F) folded rows, or per cell
    (B, L, F), or with ``segment_ids`` (B, L) per-segment tables
    (B, E + 1, F) whose row E is the padding cells'; w0: (F, Fh); b0: (Fh,);
    w1: (Fh, F); b1: (F,).  Returns the layer's new q.  Differentiable in
    every floating input (recompute backward)."""
    args = (q, attn_out, gate_a, eff_a, eff_b, gate_m, w0, b0, w1, b1)
    if kernels.needs_grad(*args):
        return _FusedDitMlp.apply(segment_ids, *args)
    return _cuda_dit_mlp(*args, segment_ids) if q.is_cuda else _ref_dit_mlp_rows(*args, segment_ids)


def mlp_config_fusable(dense_config: dict) -> bool:
    """True iff the Dense config matches the kernel's fixed chain: one
    hidden layer, LayerNorm pre-linear norm, LeakyReLU activations (hidden
    and final), no dropout, no final-layer norm, no context concat."""
    return (
        list(dense_config.get("hidden_layers", ()) or ()) != []
        and len(dense_config.get("hidden_layers")) == 1
        and dense_config.get("norm_layer") == "LayerNorm"
        and not dense_config.get("norm_final_layer", False)
        and dense_config.get("activation") == "LeakyReLU"
        and dense_config.get("final_activation") == "LeakyReLU"
        and not float(dense_config.get("dropout", 0.0) or 0.0)
        and not int(dense_config.get("context_size", 0) or 0)
    )
