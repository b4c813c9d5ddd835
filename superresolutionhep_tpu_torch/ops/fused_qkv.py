"""Fused LayerNorm + adaLN-modulate + QKV projection: a hand-written CUDA
kernel for Hopper (``csrc/fused_qkv.cu``).

The DiT attention prologue is ``modulate(norm1(x), shift, scale)`` followed
by three (F, F) projections.  The kernel reads the raw activation tile once,
computes the row statistics in fp32, applies the folded affine

    eff_a = gamma * (1 + scale)          # (B, F) — or (B, L, F) per cell
    eff_b = beta  * (1 + scale) + shift

casts to the weight dtype, and feeds the tensor cores directly; no
normalised tensor ever touches device memory.  The flash softmax pre-scale
is folded into the Q columns of the weight by the caller, so the Q third of
the output IS the pre-scaled q.

The public function keeps the JAX package's signature and logical layout:
``w`` is (F, O) and the result is (B, O, L).  In memory the result is a
(B, L, O) row-major buffer (what a GEMM writes with coalesced stores, and
what the attention kernels read with D contiguous); the (B, O, L) tensor
returned is its transposed view.
"""

from __future__ import annotations

import torch

from . import kernels

LN_EPS = 1e-5  # torch LayerNorm default; matches models/dense.py::LN_EPS
MAX_BLOCK_L = 512


def fused_qkv_ok(L: int, F: int) -> bool:
    """Shape gate (the JAX package's): F a multiple of 128 and at most 1024,
    L a positive multiple of 128."""
    return F % 128 == 0 and F <= 1024 and L >= 128 and L % 128 == 0


def _ln_noaffine(xf):
    """Two-pass fp32 LayerNorm without affine."""
    mu = xf.mean(-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(-1, keepdim=True)
    return xc * torch.rsqrt(var + LN_EPS)


def _ref_ln_mod_proj(x, a, b, w, bias):
    """Plain version: modulate(LN_noparam(x), ...) @ w + bias, transposed out.
    x (B, L, F); a, b (B, F) or (B, L, F); w (F, O); bias (O, 1) or (O,).
    y is cast to the weight dtype BEFORE the product; accumulation is fp32."""
    xhat = _ln_noaffine(x.float())
    a3 = a if a.ndim == 3 else a[:, None, :]
    b3 = b if b.ndim == 3 else b[:, None, :]
    y = xhat * a3.float() + b3.float()
    o = torch.matmul(y.to(w.dtype).float(), w.float())  # (B, L, O) fp32
    o = o + bias.float().reshape(1, 1, -1)
    return o.to(x.dtype).transpose(1, 2)  # (B, O, L)


def _cuda_ln_mod_proj(x, a, b, w, bias):
    B, L, F = x.shape
    O = w.shape[1]
    dev, dt = x.device, x.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_ln_mod_proj kernel takes bfloat16 or float32, got {dt}")
    if w.device != dev or w.dtype != dt or w.shape[0] != F:
        raise ValueError(f"fused_ln_mod_proj: w must be {dt} (F={F}, O) on {dev}, got {w.dtype} {tuple(w.shape)}")
    if not fused_qkv_ok(L, F) or O % 64:
        raise ValueError(f"fused_ln_mod_proj: shape L={L}, F={F}, O={O} not supported (fused_qkv_ok, O%64)")
    per_cell = a.ndim == 3
    want = (B, L, F) if per_cell else (B, F)
    if tuple(a.shape) != want or tuple(b.shape) != want:
        raise ValueError(f"fused_ln_mod_proj: a/b must both be {want}, got {tuple(a.shape)}, {tuple(b.shape)}")
    x = x.contiguous()
    a = a.to(device=dev, dtype=torch.float32).contiguous()
    b = b.to(device=dev, dtype=torch.float32).contiguous()
    wt = w.t().contiguous()  # (O, F): no copy when w is the transposed view of a Linear weight
    bias = bias.reshape(-1).to(device=dev, dtype=torch.float32).contiguous()
    if bias.numel() != O:
        raise ValueError(f"fused_ln_mod_proj: bias has {bias.numel()} entries, expected {O}")
    out = torch.empty((B, L, O), dtype=dt, device=dev)
    lib = kernels.library()
    with torch.cuda.device(dev):
        rc = lib.srhep_fused_qkv(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), wt.data_ptr(), bias.data_ptr(), out.data_ptr(),
            B * L, L, F, O, int(per_cell), int(dt == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    kernels.check(rc, "fused_qkv")
    kernels.LAUNCHES["fused_qkv"] += 1
    return out.transpose(1, 2)


def _recompute_vjp(ref_fn, saved, needs, g):
    """Cotangents of ``ref_fn(*saved)`` for the inputs marked in ``needs``:
    one recomputed plain forward under autograd (the JAX package's custom-VJP
    backward of the fused kernels)."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
        out = ref_fn(*inputs)
        wrt = [t for t, n in zip(inputs, needs) if n]
        grads = iter(torch.autograd.grad(out, wrt, g, allow_unused=True)) if wrt else iter(())
    return tuple(next(grads) if n else None for n in needs)


class _FusedLnModProj(torch.autograd.Function):
    """Forward: the K3 kernel (the plain version on the CPU).  Backward: a
    recompute through ``_ref_ln_mod_proj``; no backward kernel (the JAX
    package has none either)."""

    @staticmethod
    def forward(ctx, x, a, b, w, bias):
        ctx.save_for_backward(x, a, b, w, bias)
        if x.is_cuda:
            return _cuda_ln_mod_proj(x, a, b, w, bias)
        return _ref_ln_mod_proj(x, a, b, w, bias)

    @staticmethod
    def backward(ctx, g):
        return _recompute_vjp(_ref_ln_mod_proj, ctx.saved_tensors, ctx.needs_input_grad, g)


def fused_ln_mod_proj(x, a, b, w, bias):
    """modulate(LN(x), ...) @ w + bias with transposed (B, O, L) output.

    x: (B, L, F) activations; a/b: (B, F) folded affine coefficients (or
    (B, L, F) per cell); w: (F, O); bias: (O, 1) or (O,).  The LN is
    parameter-free — fold gamma/beta into a/b.  Differentiable in every
    input (recompute backward, ``_FusedLnModProj``).
    """
    if kernels.needs_grad(x, a, b, w, bias):
        return _FusedLnModProj.apply(x, a, b, w, bias)
    return _cuda_ln_mod_proj(x, a, b, w, bias) if x.is_cuda else _ref_ln_mod_proj(x, a, b, w, bias)
