"""Segment-packed attention: hand-written CUDA kernels for Hopper (the SEG
mode of ``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``)
behind the JAX package's ``ops/flash_packed.py`` entry points.

Several events lie back to back in one row of a fixed length S, each aligned
to ``SEG_ALIGN`` cells, with a per-cell segment id (``PAD_SEG`` on padding;
valid ids nondecreasing along the row, the packer's contract,
``data/packing.py``).  A cell attends exactly the cells of its own segment.
Three kernels:
  * ``packed_fwd`` (K7): online softmax with a running max on base-2 logits
    (scale * log2(e) folded into Q), additive -1e30 bias on pairs of
    different segments, rows of padding zeroed, optional base-2 LSE per
    query; ``packed_fwd_nomax`` is its inference-only no-max variant
    (``exp2(clip(s, CLIP_LO, CLIP_HI))`` times the segment-equality mask);
  * ``packed_bwd_dq`` (K8) and ``packed_bwd_dkv`` (K9): the backward from the
    saved LSE, p = exp2(min(s - lse, 0)), ds = p * (g v^T - dl).

The TPU kernels walk, per 512-wide query block, a band of key blocks computed
outside the kernel (``band_ranges``) and capped at ``max_segment_len``.  The
Hopper kernels walk the exact band at their own tiles: the bf16 kernels read
it from a table that ``packed_band`` computes once per call for all heads
(one launch of its own kernel; for the backward the same table serves dq,
key tiles per query block, and dk/dv, query tiles per key block); the fp32
kernels (K7, K8 and K9 on the tensor cores as three-term TF32 splits) find
it per block; so the entries take no block arguments.
``PACKED_DEFAULTS`` and ``set_packed_defaults`` are kept for parity with the
JAX package's API and change nothing here.  As in the TPU kernels' mask
(segment equality alone), padding cells attend each other: their output is
zeroed, but their LSE is finite and depends on the tiling, so it is compared
at valid queries only.

``_PackedAttention`` is the ``torch.autograd.Function`` (the JAX package's
``_packed_attention`` custom VJP): forward K7 with LSE, backward K8 then K9.
The no-max variant raises under grad.  On a CPU tensor the wrappers compute
the plain PyTorch versions below; on a CUDA tensor they launch the kernel or
raise.
"""

from __future__ import annotations

import math

import torch

from . import kernels
from .flash_attention import (
    BIG,
    BWD_BLOCK_T,
    CLIP_HI,
    CLIP_LO,
    FWD_BLOCK_K,
    KERNEL_HEAD_DIMS,
    LN2,
    LOG2E,
    _bwd_launch_operands,
    _check_operand,
    _heads_first,
    _strides,
    fwd_tile_rows,
    sm_count,
)

PAD_SEG = -1  # segment id of padding cells
# event-start alignment inside a packed row: data/packing.py aligns events to
# it, and models/flow_model.py derives the most segments a row can hold
# (S // SEG_ALIGN) from it
SEG_ALIGN = 128

# the JAX package's tuning knobs of the TPU kernels' blocking, kept for API
# parity: the Hopper kernels pick their own tiles and walk the exact band
PACKED_DEFAULTS = {"block_q": 512, "block_k": 512, "max_segment_len": None}

_UNSET = object()


def set_packed_defaults(block_q: int = None, block_k: int = None, max_segment_len=_UNSET):
    """Update only the provided knobs (``max_segment_len=None`` clears it)."""
    if block_q is not None:
        PACKED_DEFAULTS["block_q"] = int(block_q)
    if block_k is not None:
        PACKED_DEFAULTS["block_k"] = int(block_k)
    if max_segment_len is not _UNSET:
        PACKED_DEFAULTS["max_segment_len"] = max_segment_len


def packed_shapes_ok(S: int, d: int) -> bool:
    """The Hopper kernels' own constraint: rows a positive multiple of
    SEG_ALIGN (the packer's alignment) and a head dim they are built for."""
    return S >= SEG_ALIGN and S % SEG_ALIGN == 0 and d in KERNEL_HEAD_DIMS


def band_ranges(seg, BQ: int, BK: int):
    """Per-(row, q-block) contiguous K-block band covering every key that
    shares a segment with the block's queries (the JAX package's
    ``band_ranges``, op for op).  seg: (B, S) int.  Returns (kstart, kcnt)
    int32 (B, nQ); interior all-pad blocks lie inside the band."""
    B, S = seg.shape
    nQ, nK = S // BQ, S // BK
    big = 2**30  # a Python scalar: no host-to-device copy (the function runs inside CUDA graphs)
    segq = seg.reshape(B, nQ, BQ)
    vq = segq != PAD_SEG
    qmin = torch.where(vq, segq, big).amin(-1)
    qmax = torch.where(vq, segq, -big).amax(-1)
    segk = seg.reshape(B, nK, BK)
    vk = segk != PAD_SEG
    kmin = torch.where(vk, segk, big).amin(-1)
    kmax = torch.where(vk, segk, -big).amax(-1)
    ov = (kmin[:, None, :] <= qmax[:, :, None]) & (kmax[:, None, :] >= qmin[:, :, None])  # (B, nQ, nK)
    any_ov = ov.any(-1)
    first = ov.int().argmax(-1)
    last = nK - 1 - ov.flip(-1).int().argmax(-1)
    kstart = torch.where(any_ov, first, 0).to(torch.int32)
    kcnt = torch.where(any_ov, last - first + 1, 0).to(torch.int32)
    return kstart, kcnt


def _ref_packed_band(seg, block_q: int, block_k: int = FWD_BLOCK_K):
    """Plain version of the band kernel: ``band_ranges`` on the row padded
    with padding cells to a length both tilings divide (a ragged last query
    tile; the padding adds only all-pad key tiles past the end, and those
    overlap no band).  (B, ceil(S / block_q), 2) int32."""
    S = seg.shape[1]
    step = math.lcm(block_q, block_k)
    padded = torch.nn.functional.pad(seg, (0, -(-S // step) * step - S), value=PAD_SEG)
    return torch.stack(band_ranges(padded, block_q, block_k), -1)[:, : -(-S // block_q)]


def packed_band(seg, block_q: int, block_k: int = FWD_BLOCK_K):
    """The band table of the bf16 K7 kernel: (B, ceil(S / block_q), 2) int32
    = (first key tile, count) per (row, query tile) over block_k-wide key
    tiles, for all heads at once.  On a CUDA tensor one launch of
    ``csrc/flash_attention.cu::packed_band_kernel`` (counted as
    ``packed_band``); on a CPU tensor its plain version."""
    B, S = seg.shape
    if not seg.is_cuda:
        return _ref_packed_band(seg, block_q, block_k)
    if seg.dtype != torch.int32 or not seg.is_contiguous() or S % block_k:
        raise ValueError(f"packed band: seg must be contiguous int32 with S a multiple of {block_k}")
    band = torch.empty((B, -(-S // block_q), 2), dtype=torch.int32, device=seg.device)
    lib = kernels.library()
    with torch.cuda.device(seg.device):
        rc = lib.srhep_packed_band(seg.data_ptr(), band.data_ptr(), B, S, block_q, block_k,
                                   torch.cuda.current_stream(seg.device).cuda_stream)
    kernels.check(rc, "packed_band")
    kernels.LAUNCHES["packed_band"] += 1
    return band


# ---------------------------------------------------------------------------
# plain PyTorch versions, (B, H, S, D) layout, seg (B, S)
# ---------------------------------------------------------------------------


def _seg_eq(seg):
    """(B, 1, S, S) fp32 segment-equality mask [query, key] (padding matches
    padding, as the TPU kernels' mask)."""
    return (seg[:, :, None] == seg[:, None, :]).float()[:, None]


def _ref_packed_fwd(q_pre, k, v, seg, softmax: str = "max", with_lse: bool = False):
    """What ``_packed_fwd_kernel`` computes, step for step and cast for cast,
    over the whole row instead of a band: base-2 logits in fp32; robust: the
    (eq - 1) * 1e30 bias, p = exp2(s - max); no-max: exp2(clip(s)) * eq; the
    sum over the fp32 p, p cast to v's dtype for the PV product with fp32
    accumulation, acc / max(l, 1e-30), rows of padding zeroed.  LSE (B, H, S)
    = max + log2(max(l, 1e-30)); at padding it is not the kernel's."""
    s = torch.matmul(q_pre.float(), k.float().transpose(-1, -2))  # (B,H,S,S)
    eq = _seg_eq(seg)
    if softmax == "nomax_clip":
        p = torch.exp2(s.clamp(CLIP_LO, CLIP_HI)) * eq
        m = None
    else:
        s = s + (eq - 1.0) * BIG
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    out = acc / l.clamp_min(1e-30)
    out = (out * (seg != PAD_SEG)[:, None, :, None].float()).to(q_pre.dtype)
    if with_lse:
        return out, (m + torch.log2(l.clamp_min(1e-30))).squeeze(-1)
    return out


def _ref_packed_p(q_pre, k, lse, seg):
    """Recomputed probabilities of the backward kernels (B, H, S, S) fp32:
    p = exp2(min(s + (eq - 1) * 1e30 - lse, 0)), as ``_packed_bwd_*_kernel``."""
    s = torch.matmul(q_pre.float(), k.float().transpose(-1, -2)) + (_seg_eq(seg) - 1.0) * BIG
    return torch.exp2(torch.clamp_max(s - lse[..., None], 0.0))


def _ref_packed_bwd_dq(q_pre, k, v, g, lse, dl, seg):
    """Plain version of K8 (no ln 2): g zeroed on padding, lse/dl (B, H, S)
    fp32; ds cast to k's dtype before the product with k, fp32 accumulation,
    dq in q's dtype."""
    p = _ref_packed_p(q_pre, k, lse, seg)
    dp = torch.matmul(g.float(), v.float().transpose(-1, -2))
    ds = p * (dp - dl[..., None])
    return torch.matmul(ds.to(k.dtype).float(), k.float()).to(q_pre.dtype)


def _ref_packed_bwd_dkv(q_pre, k, v, g, lse, dl, seg):
    """Plain version of K9 (dk without ln 2): p cast to g's dtype before the dv
    product, ds to q's dtype before the dk product."""
    p = _ref_packed_p(q_pre, k, lse, seg)
    dp = torch.matmul(g.float(), v.float().transpose(-1, -2))
    ds = p * (dp - dl[..., None])
    dk = torch.matmul(ds.to(q_pre.dtype).float().transpose(-1, -2), q_pre.float()).to(k.dtype)
    dv = torch.matmul(p.to(g.dtype).float().transpose(-1, -2), g.float()).to(v.dtype)
    return dk, dv


def ref_packed_attention(q, k, v, seg, scale: float):
    """O(S^2) natural-base reference for tests (the JAX package's
    ``ref_packed_attention``): softmax over same-segment keys, (B, S, H, D)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = ((seg[:, :, None] == seg[:, None, :]) & (seg != PAD_SEG)[:, None, :])[:, None]
    s = torch.where(mask, s, torch.full((), float("-inf"), device=s.device))
    p = torch.where(mask, torch.softmax(s, dim=-1), torch.zeros((), device=s.device))  # NaN rows: all masked
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out * (seg != PAD_SEG)[:, :, None, None].float()


# ---------------------------------------------------------------------------
# CUDA launch, (B, S, H, D) views
# ---------------------------------------------------------------------------


def _cuda_packed_operands(q_pre, k, v, seg, g=None):
    B, S, H, D = q_pre.shape
    dev, dt = q_pre.device, q_pre.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"packed attention kernel takes bfloat16 or float32, got {dt}")
    if not packed_shapes_ok(S, D):
        raise ValueError(f"packed attention kernel needs S % {SEG_ALIGN} == 0 and D in {KERNEL_HEAD_DIMS}, "
                         f"got S={S}, D={D}")
    ops = [_check_operand(n, t, B, S, H, D, dt, dev) for n, t in (("q", q_pre), ("k", k), ("v", v))]
    if g is not None:
        ops.append(_check_operand("g", g, B, S, H, D, dt, dev))
    if seg.device != dev or seg.dtype != torch.int32 or tuple(seg.shape) != (B, S) or not seg.is_contiguous():
        raise ValueError(f"packed attention: seg must be contiguous int32 {(B, S)} on {dev}")
    return ops


def _packed_fwd_cuda(q_pre, k, v, seg, nomax: bool, with_lse: bool, block_q: int = None):
    """K7: out (B, S, H, D) contiguous and the base-2 LSE (B, H, S) fp32 or
    None.  bf16: one ``packed_band`` launch for the band table, then the
    kernel; ``block_q`` overrides the tile height ``fwd_tile_rows`` picks."""
    if nomax and with_lse:
        raise ValueError("the no-max kernel emits no LSE (inference only)")
    q_pre, k, v = _cuda_packed_operands(q_pre, k, v, seg)
    B, S, H, D = q_pre.shape
    dev, dt = q_pre.device, q_pre.dtype
    out = torch.empty((B, S, H, D), dtype=dt, device=dev)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=dev) if with_lse else None
    band = None
    if dt == torch.bfloat16:
        block_q = block_q or fwd_tile_rows(B, H, S, sm_count(dev))
        band = packed_band(seg, block_q)
    else:  # the fp32 kernel finds its band itself
        block_q = 0
    lib = kernels.library()
    with torch.cuda.device(dev):
        rc = lib.srhep_packed_fwd(
            q_pre.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
            band.data_ptr() if band is not None else None, out.data_ptr(),
            lse.data_ptr() if with_lse else None, B, H, S, D, *_strides(q_pre, k, v),
            int(dt == torch.bfloat16), int(nomax), block_q, torch.cuda.current_stream(dev).cuda_stream,
        )
    name = "packed_fwd_nomax" if nomax else "packed_fwd"
    kernels.check(rc, name)
    kernels.LAUNCHES[name] += 1
    return out, lse


def _check_rows(lse, dl, B, H, S, dev):
    for name, t in (("lse", lse), ("dl", dl)):
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != (B, H, S) or not t.is_contiguous():
            raise ValueError(f"packed attention backward: {name} must be contiguous float32 {(B, H, S)}")


def _packed_bwd_cuda_operands(q_pre, k, v, g, lse, dl, seg, block_rows):
    """Checks and launch operands shared by K8 and K9: bf16 adds the band
    table of the block height (one ``packed_band`` launch; queries and keys
    share ``seg``, so the same table gives dq its key tiles and dk/dv its
    query tiles)."""
    q_pre, k, v, g = _cuda_packed_operands(q_pre, k, v, seg, g)
    B, S, H, _ = q_pre.shape
    dev = q_pre.device
    _check_rows(lse, dl, B, H, S, dev)
    bf16 = q_pre.dtype == torch.bfloat16
    q_pre, k, v, g, lse, dl, block_rows, ldr = _bwd_launch_operands(q_pre, k, v, g, lse, dl, block_rows, S,
                                                                    sm_count(dev) if bf16 else 0)
    band = packed_band(seg, block_rows, BWD_BLOCK_T) if bf16 else None
    return q_pre, k, v, g, lse, dl, band, block_rows, ldr


def _packed_bwd_dq_cuda(q_pre, k, v, g, lse, dl, seg, block_rows: int = None):
    """K8: dq (B, S, H, D) in q's dtype, without the ln 2 factor; g zeroed on
    padding; lse, dl (B, H, S) fp32.  bf16: one ``packed_band`` launch for
    the band table, then the kernel; ``block_rows`` overrides the tile height
    ``bwd_tile_rows`` picks."""
    q_pre, k, v, g, lse, dl, band, block_rows, ldr = _packed_bwd_cuda_operands(q_pre, k, v, g, lse, dl, seg,
                                                                               block_rows)
    B, S, H, D = q_pre.shape
    dev, dt = q_pre.device, q_pre.dtype
    dq = torch.empty((B, S, H, D), dtype=dt, device=dev)
    lib = kernels.library()
    with torch.cuda.device(dev):
        rc = lib.srhep_packed_bwd_dq(
            q_pre.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(), dl.data_ptr(),
            seg.data_ptr(), band.data_ptr() if band is not None else None, dq.data_ptr(), B, H, S, D,
            *_strides(q_pre, k, v, g), int(dt == torch.bfloat16), block_rows, ldr,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    kernels.check(rc, "packed_bwd_dq")
    kernels.LAUNCHES["packed_bwd_dq"] += 1
    return dq


def _packed_bwd_dkv_cuda(q_pre, k, v, g, lse, dl, seg, block_rows: int = None):
    """K9: dk, dv (B, S, H, D) in k's dtype, dk without the ln 2 factor;
    bf16 as K8 (the band of query tiles per key block)."""
    q_pre, k, v, g, lse, dl, band, block_rows, ldr = _packed_bwd_cuda_operands(q_pre, k, v, g, lse, dl, seg,
                                                                               block_rows)
    B, S, H, D = q_pre.shape
    dev, dt = q_pre.device, q_pre.dtype
    dk = torch.empty((B, S, H, D), dtype=dt, device=dev)
    dv = torch.empty((B, S, H, D), dtype=dt, device=dev)
    lib = kernels.library()
    with torch.cuda.device(dev):
        rc = lib.srhep_packed_bwd_dkv(
            q_pre.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(), dl.data_ptr(),
            seg.data_ptr(), band.data_ptr() if band is not None else None, dk.data_ptr(), dv.data_ptr(), B, H, S, D,
            *_strides(q_pre, k, v, g), int(dt == torch.bfloat16), block_rows, ldr,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    kernels.check(rc, "packed_bwd_dkv")
    kernels.LAUNCHES["packed_bwd_dkv"] += 1
    return dk, dv


# ---------------------------------------------------------------------------
# dispatch and autograd
# ---------------------------------------------------------------------------


def _packed_fwd(q_pre, k, v, seg, nomax: bool = False, with_lse: bool = False):
    """K7 on pre-scaled (B, S, H, D) views: the kernel for CUDA tensors, the
    plain version for CPU ones.  Returns (out (B, S, H, D), lse (B, H, S) or
    None)."""
    if q_pre.is_cuda:
        return _packed_fwd_cuda(q_pre, k, v, seg, nomax, with_lse)
    res = _ref_packed_fwd(*_heads_first(q_pre, k, v), seg, "nomax_clip" if nomax else "max", with_lse)
    out, lse = res if with_lse else (res, None)
    return out.permute(0, 2, 1, 3), lse


def _packed_bwd(q_pre, k, v, seg, out, lse, g):
    """Backward of the pre-scaled packed attention in (B, S, H, D) layout (the
    JAX package's ``_packed_bwd``): zero the cotangent on padding, dl =
    sum_d(out * g) in fp32, K8 then K9 (plain versions on the CPU), then the
    ln 2 of the base-2 parametrisation in fp32 and the cast.  Returns
    (dq_pre, dk, dv)."""
    g = g * (seg != PAD_SEG)[:, :, None, None].to(g.dtype)
    dl = (out.float() * g.float()).sum(-1).transpose(1, 2).contiguous()  # (B, H, S)
    if q_pre.is_cuda:
        dq = _packed_bwd_dq_cuda(q_pre, k, v, g, lse, dl, seg)
        dk, dv = _packed_bwd_dkv_cuda(q_pre, k, v, g, lse, dl, seg)
    else:
        qh, kh, vh, gh = _heads_first(q_pre, k, v, g)
        dq = _ref_packed_bwd_dq(qh, kh, vh, gh, lse, dl, seg).permute(0, 2, 1, 3)
        dk, dv = (t.permute(0, 2, 1, 3) for t in _ref_packed_bwd_dkv(qh, kh, vh, gh, lse, dl, seg))
    dq = (dq.float() * LN2).to(q_pre.dtype)
    dk = (dk.float() * LN2).to(k.dtype)
    return dq, dk, dv


class _PackedAttention(torch.autograd.Function):
    """Differentiable pre-scaled packed attention (the JAX package's
    ``_packed_attention`` with its custom VJP).  q_pre, k, v: (B, S, H, D);
    seg (B, S) int32.  Forward: K7 with LSE; backward: ``_packed_bwd``."""

    @staticmethod
    def forward(ctx, q_pre, k, v, seg):
        out, lse = _packed_fwd(q_pre, k, v, seg, nomax=False, with_lse=True)
        ctx.save_for_backward(q_pre, k, v, seg, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q_pre, k, v, seg, out, lse = ctx.saved_tensors
        dq, dk, dv = _packed_bwd(q_pre, k, v, seg, out, lse, g)
        return dq, dk, dv, None


def _packed_attend_pre(q_pre, k, v, seg, softmax: str):
    """Packed attention on pre-scaled (B, S, H, D) views: the differentiable
    Function when a gradient is needed, else one forward launch (or its plain
    version on the CPU)."""
    seg = seg.to(torch.int32).contiguous()
    nomax = softmax == "nomax_clip"
    if kernels.needs_grad(q_pre, k, v):
        if nomax:
            raise RuntimeError("the no-max packed attention kernel is inference-only and not differentiable")
        return _PackedAttention.apply(q_pre, k, v, seg)
    return _packed_fwd(q_pre, k, v, seg, nomax=nomax)[0]


# ---------------------------------------------------------------------------
# public entries
# ---------------------------------------------------------------------------


def packed_flash_attention_T(qT_pre, kT, vT, seg, softmax: str = "max"):
    """Transposed-layout entry: qT_pre/kT/vT (B, H, D, S) with the softmax
    scale and base-2 conversion ALREADY folded into qT_pre (the fused
    LN+modulate+QKV prologue emits exactly this, as strided views of its
    buffer, which reach the kernel without a copy).  Returns outT (B, H, D, S).
    ``block_q``/``block_k``/``max_segment_len``: see the module docstring."""
    q, k, v = (t.permute(0, 3, 1, 2) for t in (qT_pre, kT, vT))  # (B, S, H, D) views
    return _packed_attend_pre(q, k, v, seg, softmax).permute(0, 2, 3, 1)


def packed_flash_attention(q, k, v, seg, scale: float, softmax: str = "max"):
    """Segment-packed attention.  q, k, v: (B, S, H, D); seg: (B, S) int with
    PAD_SEG (-1) padding and nondecreasing valid ids.  Cells attend exactly
    to cells of the same segment.  Returns (B, S, H, D).

    softmax='max' is differentiable (K7 with LSE forward, K8/K9 backward);
    softmax='nomax_clip' is inference-only (validate per checkpoint with
    ``nomax_selfcheck``) and raises under grad.  CUDA tensors must pass
    ``packed_shapes_ok``."""
    q_pre = q * torch.tensor(scale * LOG2E, dtype=q.dtype, device=q.device)
    return _packed_attend_pre(q_pre, k, v, seg, softmax)
