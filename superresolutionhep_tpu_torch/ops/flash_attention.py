"""Padding-masked flash attention forward: hand-written CUDA kernels for
Hopper (``csrc/flash_attention.cu``) behind the JAX package's entry points.

Two kernels from one source:
  * ``flash_fwd`` — online softmax with a running max on base-2 logits
    (scale * log2(e) folded into Q outside the kernel), additive -1e30 bias
    on padded keys, key tiles without a valid key skipped, padded query rows
    zeroed, optional base-2 log-sum-exp per query (the backward needs it);
  * ``flash_fwd_nomax`` — inference only: ``exp2(clip(s, CLIP_LO, CLIP_HI))``
    times the key mask, no running max.  Exact while every row's logits lie
    inside the clip bounds, which ``nomax_selfcheck`` proves per checkpoint.

Public layouts are the JAX package's: (B, L, H, D) into
``masked_flash_attention``, (B, H, D, L) into ``masked_flash_attention_T``;
masks are True == valid.  The kernels read Q/K/V as (B, L, H, D) views with
D contiguous and arbitrary (16-byte aligned) strides for B, L and H, so the
transposed entry costs no copy when its input is a transposed view of a
(B, L, 3F) projection (which is what ``ops/fused_qkv.py`` returns).

On a CPU tensor the wrappers compute the plain PyTorch versions below; on a
CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

import torch

from . import kernels

NEG_INF = -1e30
BIG = 1e30

# no-max kernel clip bounds (base-2 logits): HI keeps l = sum(p) < L * 2^80
# finite in fp32; LO is the subnormal floor.
CLIP_LO = -126.0
CLIP_HI = 80.0

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453

# head dims the CUDA source instantiates
KERNEL_HEAD_DIMS = (16, 32, 64)


def flash_shapes_ok(Lq: int, Lk: int, d: int) -> bool:
    """Dispatch gate, the JAX package's rule: both lengths splittable into
    128-aligned blocks (i.e. positive multiples of 128) and d % 8 == 0."""
    return Lq >= 128 and Lq % 128 == 0 and Lk >= 128 and Lk % 128 == 0 and d % 8 == 0


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def _ref_attention(q, k, v, qm, km, scale):
    """q, k, v: (B, H, L, D); qm (B, 1, Lq), km (B, 1, Lk) float.  Natural-base
    softmax with fp32 scores; returns (out, p).  Cast for cast the JAX
    package's ``_ref_attention``."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    mask = km[:, None, :, :] > 0  # (B,1,1,Lk)
    s = torch.where(mask, s, torch.full((), NEG_INF, dtype=s.dtype, device=s.device))
    s = s - s.amax(dim=-1, keepdim=True)
    p = torch.exp(s)
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    p = torch.where(mask, p, torch.zeros((), dtype=p.dtype, device=p.device))
    out = torch.matmul(p.to(v.dtype), v)
    out = out * (qm.transpose(-1, -2)[:, None] > 0).to(out.dtype)  # (B,1,Lq,1)
    return out, p


def _ref_attention_base2(q_pre, k, v, qm, km, softmax: str = "max", with_lse: bool = False):
    """Plain version of what the kernels compute, step for step: q_pre is
    already scaled by scale*log2(e); (B, H, L, D) layout.  The unnormalised
    probabilities are cast to v's dtype before the PV product (fp32
    accumulate) and the sum is divided out afterwards."""
    s = torch.matmul(q_pre.float(), k.float().transpose(-1, -2))  # (B,H,Lq,Lk) fp32
    kmf = km[:, None, :, :].float()  # (B,1,1,Lk)
    if softmax == "nomax_clip":
        p = torch.exp2(s.clamp(CLIP_LO, CLIP_HI)) * kmf
        m = None
    else:
        s = s + (kmf - 1.0) * BIG
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    out = acc / l.clamp_min(1e-30)
    out = out * (qm.transpose(-1, -2)[:, None] > 0).to(out.dtype)
    out = out.to(q_pre.dtype)
    if with_lse:
        lse = (m + torch.log2(l.clamp_min(1e-30))).squeeze(-1)  # (B,H,Lq)
        return out, lse
    return out


# ---------------------------------------------------------------------------
# CUDA launch
# ---------------------------------------------------------------------------


def _check_operand(name, t, B, L, H, D, dtype, device):
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"flash attention: {name} is {t.dtype} on {t.device}, expected {dtype} on {device}")
    if tuple(t.shape) != (B, L, H, D):
        raise ValueError(f"flash attention: {name} has shape {tuple(t.shape)}, expected {(B, L, H, D)}")
    if t.stride(3) != 1:
        t = t.contiguous()
    esz = t.element_size()
    if t.data_ptr() % 16 or any((t.stride(i) * esz) % 16 for i in range(3)):
        t = t.contiguous()
        if t.data_ptr() % 16:
            raise ValueError(f"flash attention: {name} is not 16-byte aligned")
    return t


def _flash_fwd_cuda(q_pre, k, v, qm, km, nomax: bool, with_lse: bool):
    """q_pre, k, v: (B, L, H, D) views (D contiguous) on one CUDA device;
    qm (B, Lq), km (B, Lk) float32.  Returns out (B, Lq, H, D) contiguous
    and the base-2 LSE (B, H, Lq) fp32 or None."""
    B, Lq, H, D = q_pre.shape
    Lk = k.shape[1]
    dev, dt = q_pre.device, q_pre.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"flash attention kernel takes bfloat16 or float32, got {dt}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash attention kernel is built for head dims {KERNEL_HEAD_DIMS}, got {D}")
    if nomax and with_lse:
        raise ValueError("the no-max kernel emits no LSE (inference only)")
    q_pre = _check_operand("q", q_pre, B, Lq, H, D, dt, dev)
    k = _check_operand("k", k, B, Lk, H, D, dt, dev)
    v = _check_operand("v", v, B, Lk, H, D, dt, dev)
    for name, m, L in (("q mask", qm, Lq), ("k mask", km, Lk)):
        if m.device != dev or m.dtype != torch.float32 or tuple(m.shape) != (B, L) or not m.is_contiguous():
            raise ValueError(f"flash attention: {name} must be contiguous float32 {(B, L)} on {dev}")
    out = torch.empty((B, Lq, H, D), dtype=dt, device=dev)
    lse = torch.empty((B, H, Lq), dtype=torch.float32, device=dev) if with_lse else None
    lib = kernels.library()
    with torch.cuda.device(dev):
        rc = lib.srhep_flash_fwd(
            q_pre.data_ptr(), k.data_ptr(), v.data_ptr(), qm.data_ptr(), km.data_ptr(),
            out.data_ptr(), lse.data_ptr() if with_lse else None,
            B, H, Lq, Lk, D,
            q_pre.stride(0), q_pre.stride(1), q_pre.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            int(dt == torch.bfloat16), int(nomax),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    name = "flash_fwd_nomax" if nomax else "flash_fwd"
    kernels.check(rc, name)
    kernels.LAUNCHES[name] += 1
    return out, lse


def _float_mask(valid, B, L, device):
    if valid is None:
        return torch.ones((B, L), dtype=torch.float32, device=device)
    return valid.to(torch.float32).contiguous()


# ---------------------------------------------------------------------------
# public entries
# ---------------------------------------------------------------------------


def masked_flash_attention(q, k, v, q_valid, kv_valid, scale: float, softmax: str = "max"):
    """q, k, v: (B, L, H, D) with True==valid padding masks (B, L) or None.
    Returns (B, Lq, H, D).

    softmax='max': online softmax with a running max, exact for any logits.
    softmax='nomax_clip': inference-only clipped exp2 without the max chain;
    validate per checkpoint with ``nomax_selfcheck`` before trusting it.

    CUDA tensors go through the kernel and must pass ``flash_shapes_ok``
    (callers gate on it, as in the JAX package); CPU tensors take the plain
    versions at any shape.
    """
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    qm = _float_mask(q_valid, B, Lq, q.device)
    km = _float_mask(kv_valid, B, Lk, q.device)
    if q.is_cuda:
        if not flash_shapes_ok(Lq, Lk, D):
            raise ValueError(
                f"masked_flash_attention: shape (Lq={Lq}, Lk={Lk}, D={D}) fails the flash-kernel "
                f"gate (128-aligned L, D%8==0); gate on flash_shapes_ok and use the einsum path"
            )
        q_pre = q * (scale * LOG2E)
        out, _ = _flash_fwd_cuda(q_pre, k, v, qm, km, nomax=softmax == "nomax_clip", with_lse=False)
        return out
    qh, kh, vh = (t.permute(0, 2, 1, 3) for t in (q, k, v))
    if softmax == "nomax_clip":
        out = _ref_attention_base2(qh * (scale * LOG2E), kh, vh, qm[:, None], km[:, None], softmax)
    else:
        out, _ = _ref_attention(qh, kh, vh, qm[:, None], km[:, None], scale)
    return out.permute(0, 2, 1, 3)


def masked_flash_attention_T(qT_pre, kT, vT, q_valid, kv_valid, softmax: str = "max", with_lse: bool = False):
    """Transposed-layout entry: qT_pre/kT/vT (B, H, D, L) with the softmax
    scale and base-2 conversion ALREADY folded into qT_pre (the fused
    LN+modulate+QKV prologue emits exactly this).  Returns outT (B, H, D, Lq)
    (a transposed view of a (B, Lq, H, D) buffer); with ``with_lse`` also the
    base-2 log-sum-exp (B, H, 1, Lq) fp32."""
    B, H, D, Lq = qT_pre.shape
    Lk = kT.shape[3]
    qm = _float_mask(q_valid, B, Lq, qT_pre.device)
    km = _float_mask(kv_valid, B, Lk, qT_pre.device)
    nomax = softmax == "nomax_clip"
    if qT_pre.is_cuda:
        if not flash_shapes_ok(Lq, Lk, D):
            raise ValueError(f"masked_flash_attention_T: shape (Lq={Lq}, Lk={Lk}, D={D}) fails flash_shapes_ok")
        q, k, v = (t.permute(0, 3, 1, 2) for t in (qT_pre, kT, vT))  # (B, L, H, D) views
        out, lse = _flash_fwd_cuda(q, k, v, qm, km, nomax=nomax, with_lse=with_lse)
        outT = out.permute(0, 2, 3, 1)
    else:
        q, k, v = (t.permute(0, 1, 3, 2) for t in (qT_pre, kT, vT))  # (B, H, L, D)
        res = _ref_attention_base2(q, k, v, qm[:, None], km[:, None], softmax, with_lse=with_lse)
        out, lse = res if with_lse else (res, None)
        outT = out.permute(0, 1, 3, 2)
    if with_lse:
        return outT, lse[:, :, None, :]
    return outT


def nomax_selfcheck(apply_robust, apply_nomax, batch, atol: float = 6e-2) -> bool:
    """Per-checkpoint validation gate for the no-max kernel: run the same
    forward through the robust and the clipped no-max attention and compare.
    The clip is exact iff the model's attention logits stay inside
    (CLIP_LO, CLIP_HI); this proves it on a representative batch.  bf16
    accumulation-order noise between the two softmax formulations stays well
    under ``atol`` while clip saturation produces O(1) differences."""
    a = apply_robust(batch).float()
    b = apply_nomax(batch).float()
    return bool((a - b).abs().max() < atol)
