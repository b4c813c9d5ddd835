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
shared memory and registers, and writes the new q tile once.

Shape contract: the production DiT MLP exactly — one hidden layer,
pre-linear parameter-free LayerNorm, LeakyReLU(0.01) activations, no context
concat, dropout 0.  The caller gates on ``mlp_config_fusable`` /
``fused_mlp_ok`` and takes the standard path otherwise.
"""

from __future__ import annotations

import torch

from . import kernels
from .fused_qkv import _ln_noaffine, _recompute_vjp

LRELU_SLOPE = 0.01  # torch default — models/dense.py ACTIVATIONS

# shared memory one block may use on an H100, and what the kernel needs
_SMEM_LIMIT = 232448


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


def kernel_smem_bytes(F: int, Fh: int, itemsize: int) -> int:
    """Dynamic shared memory of one block of the kernel (64 rows): the
    normalised tile, the hidden tile and two weight slabs; 16 bytes of row
    padding each (see csrc/fused_mlp.cu)."""
    pad = 16 // itemsize
    return 64 * ((F + pad) + (Fh + pad) + 2 * (128 + pad)) * itemsize


def _cuda_dit_mlp(q, attn_out, gate_a, eff_a, eff_b, gate_m, w0, b0, w1, b1):
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
    need = kernel_smem_bytes(F, Fh, q.element_size())
    if need > _SMEM_LIMIT:
        raise ValueError(
            f"fused_dit_mlp: F={F}, Fh={Fh} in {dt} needs {need} bytes of shared memory per block, "
            f"more than the {_SMEM_LIMIT} a block may use"
        )
    per_cell = gate_a.ndim == 3
    want = (B, L, F) if per_cell else (B, F)
    rows = []
    for name, r in (("gate_a", gate_a), ("eff_a", eff_a), ("eff_b", eff_b), ("gate_m", gate_m)):
        if tuple(r.shape) != want:
            raise ValueError(f"fused_dit_mlp: {name} must be {want}, got {tuple(r.shape)}")
        rows.append(r.to(device=dev, dtype=torch.float32).contiguous())
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
            w0t.data_ptr(), b0.data_ptr(), w1t.data_ptr(), b1.data_ptr(), out.data_ptr(),
            B * L, L, F, Fh, int(per_cell), int(dt == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    kernels.check(rc, "fused_mlp")
    kernels.LAUNCHES["fused_mlp"] += 1
    return out


class _FusedDitMlp(torch.autograd.Function):
    """Forward: the K4 kernel (the plain version on the CPU).  Backward: a
    recompute through ``_ref_dit_mlp``, as the JAX package's custom VJP."""

    @staticmethod
    def forward(ctx, *args):
        ctx.save_for_backward(*args)
        if args[0].is_cuda:
            return _cuda_dit_mlp(*args)
        return _ref_dit_mlp(*args)

    @staticmethod
    def backward(ctx, g):
        return _recompute_vjp(_ref_dit_mlp, ctx.saved_tensors, ctx.needs_input_grad, g)


def fused_dit_mlp(q, attn_out, gate_a, eff_a, eff_b, gate_m, w0, b0, w1, b1):
    """One-pass DiT MLP half-layer (module docstring).  q/attn_out:
    (B, L, F); gate_a/eff_a/eff_b/gate_m: (B, F) folded rows — or per-cell
    (B, L, F); w0: (F, Fh); b0: (Fh,); w1: (Fh, F); b1: (F,).  Returns the
    layer's new q.  Differentiable in every input (recompute backward)."""
    args = (q, attn_out, gate_a, eff_a, eff_b, gate_m, w0, b0, w1, b1)
    if kernels.needs_grad(*args):
        return _FusedDitMlp.apply(*args)
    return _cuda_dit_mlp(*args) if q.is_cuda else _ref_dit_mlp(*args)


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
