"""Fused LayerNorm + adaLN-modulate + QKV projection: a hand-written CUDA
kernel for Hopper (``csrc/fused_qkv.cu``).

The DiT attention prologue is ``modulate(norm1(x), shift, scale)`` followed
by three (F, F) projections.  The kernel reads the raw activation tile once,
computes the row statistics in fp32, applies the folded affine

    eff_a = gamma * (1 + scale)
    eff_b = beta  * (1 + scale) + shift

casts to the weight dtype, and feeds the tensor cores directly; no
normalised tensor ever touches device memory.  The flash softmax pre-scale
is folded into the Q columns of the weight by the caller, so the Q third of
the output IS the pre-scaled q.

The modulation rows come in three forms: one row per batch row (B, F), one
per cell (B, L, F), or, for segment-packed rows, one per segment: a table
(B, E + 1, F) with the (B, L) int32 ``segment_ids`` of the packed batch;
row E is the zero-modulation row that padding cells (id -1) get, what the
one-hot scatter of the JAX package gives them (``ops/masked.py::
segment_table``).  The kernel gathers each cell's row from the table.

The public function keeps the JAX package's signature and logical layout:
``w`` is (F, O) and the result is (B, O, L).  In memory the result is a
(B, L, O) row-major buffer (what a GEMM writes with coalesced stores, and
what the attention kernels read with D contiguous); the (B, O, L) tensor
returned is its transposed view.

Two gates decide whether a shape takes the kernel: ``fused_qkv_ok``, the JAX
package's rule, and ``fused_qkv_capacity_ok``, what the kernel is built for
(``kernel_smem_bytes``: the shared memory one block of the kernel asks for,
which the launcher checks against its own layout at every launch).
"""

from __future__ import annotations

import torch

from . import kernels
from .masked import gather_segment_rows

LN_EPS = 1e-5  # torch LayerNorm default; matches models/dense.py::LN_EPS
MAX_BLOCK_L = 512

# shared memory one block may use on an H100
SMEM_LIMIT = 232448
# widths F (and, for the MLP, Fh) the bf16 body of csrc/fused_qkv.cu and
# csrc/fused_mlp.cu is instantiated for
KERNEL_WIDTHS = (128, 256)
# how the modulation rows are laid out (the kernels' `mode` argument)
ROWS_PER_BATCH, ROWS_PER_CELL, ROWS_PER_SEGMENT = 0, 1, 2


def fused_qkv_ok(L: int, F: int) -> bool:
    """Shape gate (the JAX package's): F a multiple of 128 and at most 1024,
    L a positive multiple of 128."""
    return F % 128 == 0 and F <= 1024 and L >= 128 and L % 128 == 0


def kernel_smem_bytes(F: int, itemsize: int) -> int:
    """Dynamic shared memory of one block of csrc/fused_qkv.cu.  bf16 (the
    wgmma body): 1 KB of alignment slack; for each of two 64-row warpgroups
    the swizzled A tile, the raw rows of its next tile and a 64 x 128 output
    staging tile; a ring of four 128 x 64 weight slabs; twelve barriers.
    fp32: the normalised 64-row tile, two 64 x 128 weight slabs and the
    64 x 64 output tile, each row padded by 16 bytes."""
    if itemsize == 2:
        return 1024 + 2 * 2 * 64 * F * 2 + 2 * 64 * 128 * 2 + 4 * 128 * 64 * 2 + 8 * (2 * 4 + 2 * 2)
    return (64 * (F + 4) + 2 * 64 * (128 + 4) + 64 * (64 + 4)) * 4


def fused_qkv_capacity_ok(F: int, dtype) -> bool:
    """Whether the kernel takes width F in ``dtype``: a width the bf16 body
    is built for, and a block that fits the card's shared memory.  The model
    consults it beside ``fused_qkv_ok`` and takes the unfused formulation
    where it fails, on every device alike."""
    if dtype == torch.bfloat16:
        return F in KERNEL_WIDTHS and kernel_smem_bytes(F, 2) <= SMEM_LIMIT
    return dtype == torch.float32 and F % 128 == 0 and kernel_smem_bytes(F, 4) <= SMEM_LIMIT


def rows_mode(a, B: int, L: int, segment_ids=None):
    """The layout of modulation rows ``a`` for a (B, L, .) activation, and
    the number of table rows (E + 1) in the segment form; raises on a shape
    that fits none of the three forms."""
    F = a.shape[-1]
    if segment_ids is not None:
        if a.ndim != 3 or a.shape[0] != B or a.shape[1] < 1:
            raise ValueError(f"segment-form rows must be (B={B}, E + 1, F), got {tuple(a.shape)}")
        if tuple(segment_ids.shape) != (B, L):
            raise ValueError(f"segment_ids must be (B={B}, L={L}), got {tuple(segment_ids.shape)}")
        return ROWS_PER_SEGMENT, a.shape[1]
    if tuple(a.shape) == (B, L, F):
        return ROWS_PER_CELL, 0
    if tuple(a.shape) == (B, F):
        return ROWS_PER_BATCH, 0
    raise ValueError(f"modulation rows must be (B, F), (B, L, F) or a segment table, got {tuple(a.shape)}")


def cell_rows(r, segment_ids):
    """Per-cell rows of a segment table (the plain versions' gather); rows of
    the other two forms unchanged."""
    return r if segment_ids is None else gather_segment_rows(r, segment_ids)


def kernel_rows(rows, dev, segment_ids=None):
    """fp32 contiguous modulation rows for a launch, and the segment ids as
    contiguous int32 (or None)."""
    rows = [r.to(device=dev, dtype=torch.float32).contiguous() for r in rows]
    if segment_ids is not None:
        if segment_ids.device != dev:
            raise ValueError(f"segment_ids must lie on {dev}, got {segment_ids.device}")
        segment_ids = segment_ids.to(torch.int32).contiguous()
    return rows, segment_ids


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


def _ref_ln_mod_proj_rows(x, a, b, w, bias, segment_ids=None):
    """Plain version in any of the three row forms: a segment table is
    gathered per cell first (bit for bit the one-hot scatter of finite
    rows), then ``_ref_ln_mod_proj``."""
    return _ref_ln_mod_proj(x, cell_rows(a, segment_ids), cell_rows(b, segment_ids), w, bias)


def _cuda_ln_mod_proj(x, a, b, w, bias, segment_ids=None):
    B, L, F = x.shape
    O = w.shape[1]
    dev, dt = x.device, x.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_ln_mod_proj kernel takes bfloat16 or float32, got {dt}")
    if w.device != dev or w.dtype != dt or w.shape[0] != F:
        raise ValueError(f"fused_ln_mod_proj: w must be {dt} (F={F}, O) on {dev}, got {w.dtype} {tuple(w.shape)}")
    if not fused_qkv_ok(L, F) or O % 128:
        raise ValueError(f"fused_ln_mod_proj: shape L={L}, F={F}, O={O} not supported (fused_qkv_ok, O%128)")
    if not fused_qkv_capacity_ok(F, dt):
        raise ValueError(f"fused_ln_mod_proj: the kernel does not take F={F} in {dt} "
                         f"({kernel_smem_bytes(F, x.element_size())} bytes of shared memory a block, "
                         f"widths {KERNEL_WIDTHS} in bf16; fused_qkv_capacity_ok)")
    mode, e1 = rows_mode(a, B, L, segment_ids)
    if a.shape != b.shape:
        raise ValueError(f"fused_ln_mod_proj: a/b must have one shape, got {tuple(a.shape)}, {tuple(b.shape)}")
    x = x.contiguous()
    (a, b), seg = kernel_rows((a, b), dev, segment_ids)
    wt = w.t().contiguous()  # (O, F): no copy when w is the transposed view of a Linear weight
    bias = bias.reshape(-1).to(device=dev, dtype=torch.float32).contiguous()
    if bias.numel() != O:
        raise ValueError(f"fused_ln_mod_proj: bias has {bias.numel()} entries, expected {O}")
    out = torch.empty((B, L, O), dtype=dt, device=dev)
    lib = kernels.library()
    with torch.cuda.device(dev):
        rc = lib.srhep_fused_qkv(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), wt.data_ptr(), bias.data_ptr(),
            seg.data_ptr() if seg is not None else None, out.data_ptr(),
            B * L, L, F, O, mode, e1, kernel_smem_bytes(F, x.element_size()), int(dt == torch.bfloat16),
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
    recompute through ``_ref_ln_mod_proj_rows``; no backward kernel (the JAX
    package has none either)."""

    @staticmethod
    def forward(ctx, x, a, b, w, bias, segment_ids):
        ctx.save_for_backward(x, a, b, w, bias)
        ctx.segment_ids = segment_ids
        if x.is_cuda:
            return _cuda_ln_mod_proj(x, a, b, w, bias, segment_ids)
        return _ref_ln_mod_proj_rows(x, a, b, w, bias, segment_ids)

    @staticmethod
    def backward(ctx, g):
        def ref(*args):
            return _ref_ln_mod_proj_rows(*args, ctx.segment_ids)

        return (*_recompute_vjp(ref, ctx.saved_tensors, ctx.needs_input_grad[:5], g), None)


def fused_ln_mod_proj(x, a, b, w, bias, segment_ids=None):
    """modulate(LN(x), ...) @ w + bias with transposed (B, O, L) output.

    x: (B, L, F) activations; a/b: (B, F) folded affine coefficients, or
    (B, L, F) per cell, or with ``segment_ids`` (B, L) a per-segment table
    (B, E + 1, F) whose row E is the padding cells' (module docstring);
    w: (F, O); bias: (O, 1) or (O,).  The LN is parameter-free — fold
    gamma/beta into a/b.  Differentiable in every floating input (recompute
    backward, ``_FusedLnModProj``).
    """
    if kernels.needs_grad(x, a, b, w, bias):
        return _FusedLnModProj.apply(x, a, b, w, bias, segment_ids)
    if x.is_cuda:
        return _cuda_ln_mod_proj(x, a, b, w, bias, segment_ids)
    return _ref_ln_mod_proj_rows(x, a, b, w, bias, segment_ids)
