"""Padding-masked flash attention: hand-written CUDA kernels for Hopper
(``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``) behind the
JAX package's entry points.

Four kernels:
  * ``flash_fwd`` — online softmax with a running max on base-2 logits
    (scale * log2(e) folded into Q outside the kernel), additive -1e30 bias
    on padded keys, key tiles without a valid key skipped, padded query rows
    zeroed, optional base-2 log-sum-exp per query (the backward needs it);
  * ``flash_fwd_nomax`` — inference only: ``exp2(clip(s, CLIP_LO, CLIP_HI))``
    times the key mask, no running max.  Exact while every row's logits lie
    inside the clip bounds, which ``nomax_selfcheck`` proves per checkpoint;
  * ``flash_bwd_dq`` and ``flash_bwd_dkv`` — the backward from the saved
    LSE: p = exp2(min(s - lse, 0)), ds = p * (g v^T - dl).

``_FlashAttention`` is the ``torch.autograd.Function`` around the pre-scaled
kernels (the JAX package's ``_flash_attention`` custom VJP): forward with
LSE, backward through ``_flash_bwd``.  The q pre-scale stays outside it, so
autograd chains d/dq through the product as JAX does.

Public layouts are the JAX package's: (B, L, H, D) into
``masked_flash_attention``, (B, H, D, L) into ``masked_flash_attention_T``;
masks are True == valid.  The kernels read Q/K/V as (B, L, H, D) views with
D contiguous and arbitrary (16-byte aligned) strides for B, L and H, so the
transposed entry costs no copy when its input is a transposed view of a
(B, L, 3F) projection (which is what ``ops/fused_qkv.py`` returns).

Each kernel has a bf16 and an fp32 build.  bf16: TMA + wgmma.  fp32 (PF's
default precision, SR's "default"): the forward, dq and dk/dv take their
products on the tensor cores as three-term TF32 splits, lo*hi + hi*lo +
hi*hi, fp32-faithful (``csrc/tf32_attention.cuh``; ``ops/tf32_split.py``
states that arithmetic for the CPU tests).

On a CPU tensor the wrappers compute the plain PyTorch versions below; on a
CUDA tensor they launch the kernel or raise.
"""

from __future__ import annotations

import functools

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

# tiling of the bf16 forward kernel (csrc/flash_attention.cu): keys per tile,
# rows per TMA box, query rows per consumer warpgroup
FWD_BLOCK_K = 64
FWD_TMA_ROWS = 64
FWD_ROWS_PER_WARPGROUP = 64
# tiling of the bf16 backward kernels (csrc/flash_attention_bwd.cu): rows of a
# streamed tile (keys for dq, queries for dk/dv); the block's own rows are 64
# per consumer warpgroup
BWD_BLOCK_T = 64


def flash_shapes_ok(Lq: int, Lk: int, d: int) -> bool:
    """Dispatch gate, the JAX package's rule: both lengths splittable into
    128-aligned blocks (i.e. positive multiples of 128) and d % 8 == 0."""
    return Lq >= 128 and Lq % 128 == 0 and Lk >= 128 and Lk % 128 == 0 and d % 8 == 0


def flash_kernel_ok(d: int) -> bool:
    """Capacity gate: a head dim the kernels are built for.  The model
    consults it beside ``flash_shapes_ok`` and takes the dense formulation
    where it fails, on every device alike."""
    return d in KERNEL_HEAD_DIMS


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
    accumulate) and the sum is divided out afterwards.  p is zeroed on padded
    keys: the kernels skip key tiles without a valid key, which matters only
    for a row with no valid key at all (its output is then 0, not the mean
    of v, and its LSE stays ~-1e30)."""
    s = torch.matmul(q_pre.float(), k.float().transpose(-1, -2))  # (B,H,Lq,Lk) fp32
    kmf = km[:, None, :, :].float()  # (B,1,1,Lk)
    if softmax == "nomax_clip":
        p = torch.exp2(s.clamp(CLIP_LO, CLIP_HI)) * kmf
        m = None
    else:
        s = s + (kmf - 1.0) * BIG
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp2(s - m) * kmf
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    out = acc / l.clamp_min(1e-30)
    out = out * (qm.transpose(-1, -2)[:, None] > 0).to(out.dtype)
    out = out.to(q_pre.dtype)
    if with_lse:
        lse = (m + torch.log2(l.clamp_min(1e-30))).squeeze(-1)  # (B,H,Lq)
        return out, lse
    return out


def _ref_bwd_p(q_pre, k, lse, km):
    """Recomputed probabilities of the backward kernels, (B, H, Lq, Lk) fp32:
    p = exp2(min(s - lse, 0)) on base-2 logits with the -1e30 bias on padded
    keys, zeroed on padded keys (the kernels skip key tiles without a valid
    key; that matters only for a row with no valid key, whose LSE is ~-1e30
    and whose capped p would otherwise be 1)."""
    kmf = km[:, None, :, :].float()  # (B,1,1,Lk)
    s = torch.matmul(q_pre.float(), k.float().transpose(-1, -2)) + (kmf - 1.0) * BIG
    return torch.exp2(torch.clamp_max(s - lse[..., None], 0.0)) * kmf


def _ref_flash_bwd_dq(q_pre, k, v, g, lse, dl, km):
    """Plain version of the dq kernel (no ln 2): (B, H, L, D) layout, g
    already zeroed on padded queries, lse/dl (B, H, Lq) fp32.  ds is cast to
    k's dtype before the product with k; fp32 accumulation; dq in q's dtype."""
    p = _ref_bwd_p(q_pre, k, lse, km)
    dp = torch.matmul(g.float(), v.float().transpose(-1, -2))
    ds = p * (dp - dl[..., None])
    return torch.matmul(ds.to(k.dtype).float(), k.float()).to(q_pre.dtype)


def _ref_flash_bwd_dkv(q_pre, k, v, g, lse, dl, km):
    """Plain version of the dk/dv kernel (dk without ln 2): ds cast to q's
    dtype before the dk product, p cast to g's dtype before the dv product."""
    p = _ref_bwd_p(q_pre, k, lse, km)
    dp = torch.matmul(g.float(), v.float().transpose(-1, -2))
    ds = p * (dp - dl[..., None])
    dk = torch.matmul(ds.to(q_pre.dtype).float().transpose(-1, -2), q_pre.float()).to(k.dtype)
    dv = torch.matmul(p.to(g.dtype).float().transpose(-1, -2), g.float()).to(v.dtype)
    return dk, dv


def _ref_flash_bwd(q_pre, k, v, g, lse, dl, km):
    """Plain version of both backward kernels, step for step and cast for
    cast what ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel`` do.  Returns
    (dq_pre, dk, dv) before the ln 2 of the base-2 parametrisation."""
    dk, dv = _ref_flash_bwd_dkv(q_pre, k, v, g, lse, dl, km)
    return _ref_flash_bwd_dq(q_pre, k, v, g, lse, dl, km), dk, dv


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


def _cuda_operands(q_pre, k, v, qm, km):
    """Checks shared by every attention kernel: dtype, head dim, shapes,
    strides, masks.  Returns q_pre, k, v as (B, L, H, D) views the kernels
    take (copied only when a stride does not fit)."""
    B, Lq, H, D = q_pre.shape
    Lk = k.shape[1]
    dev, dt = q_pre.device, q_pre.dtype
    if dt not in (torch.bfloat16, torch.float32):
        raise ValueError(f"flash attention kernel takes bfloat16 or float32, got {dt}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash attention kernel is built for head dims {KERNEL_HEAD_DIMS}, got {D}")
    q_pre = _check_operand("q", q_pre, B, Lq, H, D, dt, dev)
    k = _check_operand("k", k, B, Lk, H, D, dt, dev)
    v = _check_operand("v", v, B, Lk, H, D, dt, dev)
    for name, m, L in (("q mask", qm, Lq), ("k mask", km, Lk)):
        if m.device != dev or m.dtype != torch.float32 or tuple(m.shape) != (B, L) or not m.is_contiguous():
            raise ValueError(f"flash attention: {name} must be contiguous float32 {(B, L)} on {dev}")
    return q_pre, k, v


def _strides(*ts):
    return [st for t in ts for st in (t.stride(0), t.stride(1), t.stride(2))]


# ---------------------------------------------------------------------------
# host-side plan of the bf16 forward kernel (pure functions of shapes and
# strides: what the wrapper picks and what the C side encodes)
# ---------------------------------------------------------------------------


def fwd_tile_rows(B: int, H: int, Lq: int, sm_count: int) -> int:
    """Query rows per block of the bf16 forward kernel: 192 (three consumer
    warpgroups, so that each K/V tile serves 192 queries) while the grid then
    still holds two blocks per SM, else 64 (one consumer warpgroup, two
    blocks resident per SM), so that a small grid such as a serve bucket
    still spreads over the card.  (128 rows, two consumer warpgroups, was
    never the fastest of the three on the H100 and is not built.)"""
    return 192 if B * H * -(-Lq // 192) >= 2 * sm_count else 64


def tensor_map_plan(t) -> dict:
    """The TMA tensor map ``csrc/flash_attention.cu::encode_operand`` builds
    for a (B, L, H, D) bf16 view with D contiguous: dims (D, L, H, B)
    innermost first, byte strides of L, H and B, box (D, 64, 1, 1), swizzle
    the row's 2*D bytes (the layout the kernel's wgmma descriptors assume);
    rows past L read as zeros.  Raises ValueError for a view the TMA cannot
    take: another dtype or head dim, D not contiguous, a base address or a
    stride that is not a multiple of 16 bytes."""
    if t.dim() != 4:
        raise ValueError(f"tensor map: expected a (B, L, H, D) view, got shape {tuple(t.shape)}")
    B, L, H, D = t.shape
    if t.dtype != torch.bfloat16 or D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"tensor map: the bf16 kernel takes bfloat16 with D in {KERNEL_HEAD_DIMS}, got {t.dtype}, D={D}")
    if t.stride(3) != 1:
        raise ValueError(f"tensor map: the head dim must be contiguous, strides {t.stride()}")
    esz = t.element_size()
    strides = tuple(t.stride(i) * esz for i in (1, 2, 0))
    if t.data_ptr() % 16 or any(st % 16 or st >= 2**40 for st in strides):
        raise ValueError(f"tensor map: base address and the byte strides {strides} of L, H, B must be multiples of 16")
    if any(t.stride(i) == 0 and t.shape[i] > 1 for i in range(3)):
        raise ValueError(f"tensor map: a broadcast view (stride 0, strides {t.stride()}) is no tensor the TMA reads")
    return {"dims": (D, L, H, B), "strides_bytes": strides, "box": (D, FWD_TMA_ROWS, 1, 1), "swizzle_bytes": D * esz}


def tensor_map_ok(t) -> bool:
    """Whether ``tensor_map_plan`` takes the view ``t``."""
    try:
        tensor_map_plan(t)
    except ValueError:
        return False
    return True


def fwd_plan(q_pre, k, v, sm_count: int) -> dict:
    """The bf16 forward kernel's launch on (B, L, H, D) views: tile height,
    grid, threads per block (the consumer warpgroups and one producer
    warpgroup) and the three tensor maps."""
    B, Lq, H, _ = q_pre.shape
    block_q = fwd_tile_rows(B, H, Lq, sm_count)
    return {"block_q": block_q, "block_k": FWD_BLOCK_K, "grid": (-(-Lq // block_q), H, B),
            "threads": 128 * (block_q // FWD_ROWS_PER_WARPGROUP + 1),
            "maps": {"q": tensor_map_plan(q_pre), "k": tensor_map_plan(k), "v": tensor_map_plan(v)}}


def bwd_tile_rows(B: int, H: int, L: int, sm_count: int) -> int:
    """Rows per block of the bf16 backward kernels (queries for dq, keys for
    dk/dv; L is that axis's length): 128 (two warpgroups, one block an SM,
    so that each streamed tile serves 128 rows) while the grid then still
    fills the card twice over, else 64 (one warpgroup, two blocks an SM), so
    that a small grid still spreads over the card."""
    return 128 if B * H * -(-L // 128) >= 2 * sm_count else 64


def bwd_rows_stride(L: int) -> int:
    """Row stride (elements) of the lse and dl rows the bf16 backward reads
    by TMA: L rounded up to a multiple of 4 (16 bytes of fp32)."""
    return -(-L // 4) * 4


def bwd_plan(q_pre, k, v, g, sm_count: int) -> dict:
    """The bf16 backward kernels' launches on (B, L, H, D) views: for dq
    (blocks of queries) and dk/dv (blocks of keys) the tile height, grid and
    threads per block (a warpgroup per 64 rows, and for dq one producer warp
    more); the streamed tile's height, the lse/dl row stride and the four
    operand maps."""
    B, Lq, H, _ = q_pre.shape
    Lk = k.shape[1]
    plan = {"block_t": BWD_BLOCK_T, "rows_stride": bwd_rows_stride(Lq),
            "maps": {"q": tensor_map_plan(q_pre), "k": tensor_map_plan(k), "v": tensor_map_plan(v),
                     "g": tensor_map_plan(g)}}
    for name, L, producer in (("dq", Lq, 32), ("dkv", Lk, 0)):
        rows = bwd_tile_rows(B, H, L, sm_count)
        plan[name] = {"block_rows": rows, "grid": (-(-L // rows), H, B), "threads": 2 * rows + producer}
    return plan


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return _sm_count(device.index if device.index is not None else torch.cuda.current_device())


def _flash_fwd_cuda(q_pre, k, v, qm, km, nomax: bool, with_lse: bool, block_q: int = None):
    """q_pre, k, v: (B, L, H, D) views (D contiguous) on one CUDA device;
    qm (B, Lq), km (B, Lk) float32.  Returns out (B, Lq, H, D) contiguous
    and the base-2 LSE (B, H, Lq) fp32 or None.  ``block_q`` (bf16 only)
    overrides the tile height ``fwd_tile_rows`` picks (64 or 192)."""
    if nomax and with_lse:
        raise ValueError("the no-max kernel emits no LSE (inference only)")
    q_pre, k, v = _cuda_operands(q_pre, k, v, qm, km)
    B, Lq, H, D = q_pre.shape
    Lk = k.shape[1]
    dev, dt = q_pre.device, q_pre.dtype
    out = torch.empty((B, Lq, H, D), dtype=dt, device=dev)
    lse = torch.empty((B, H, Lq), dtype=torch.float32, device=dev) if with_lse else None
    block_q = (block_q or fwd_tile_rows(B, H, Lq, sm_count(dev))) if dt == torch.bfloat16 else 0
    lib = kernels.library()
    with torch.cuda.device(dev):
        rc = lib.srhep_flash_fwd(
            q_pre.data_ptr(), k.data_ptr(), v.data_ptr(), qm.data_ptr(), km.data_ptr(),
            out.data_ptr(), lse.data_ptr() if with_lse else None,
            B, H, Lq, Lk, D, *_strides(q_pre, k, v),
            int(dt == torch.bfloat16), int(nomax), block_q,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    name = "flash_fwd_nomax" if nomax else "flash_fwd"
    kernels.check(rc, name)
    kernels.LAUNCHES[name] += 1
    return out, lse


def _cuda_bwd_operands(q_pre, k, v, g, lse, dl, qm, km):
    q_pre, k, v = _cuda_operands(q_pre, k, v, qm, km)
    B, Lq, H, D = q_pre.shape
    g = _check_operand("g", g, B, Lq, H, D, q_pre.dtype, q_pre.device)
    for name, t in (("lse", lse), ("dl", dl)):
        if t.device != q_pre.device or t.dtype != torch.float32 or tuple(t.shape) != (B, H, Lq) or not t.is_contiguous():
            raise ValueError(f"flash attention backward: {name} must be contiguous float32 {(B, H, Lq)}")
    return q_pre, k, v, g


def _bwd_launch_operands(q_pre, k, v, g, lse, dl, block_rows, L, sm_count: int):
    """What the backward kernels are handed beyond the checks: for bf16 the
    operands as the TMA takes them (a view it cannot take, such as a
    broadcast cotangent, copied contiguous), lse and dl with rows padded to
    ``bwd_rows_stride`` where L is no multiple of 4, and the tile height
    (``block_rows`` or ``bwd_tile_rows`` over the blocks' axis of length L);
    fp32 takes them as they are.  Returns (q_pre, k, v, g, lse, dl,
    block_rows, row stride)."""
    Lq = q_pre.shape[1]
    if q_pre.dtype != torch.bfloat16:
        return q_pre, k, v, g, lse, dl, 0, Lq
    q_pre, k, v, g = (t if tensor_map_ok(t) else t.contiguous() for t in (q_pre, k, v, g))
    ldr = bwd_rows_stride(Lq)
    if ldr != Lq:
        lse, dl = (torch.nn.functional.pad(t, (0, ldr - Lq)) for t in (lse, dl))
    B, _, H, _ = q_pre.shape
    return q_pre, k, v, g, lse, dl, block_rows or bwd_tile_rows(B, H, L, sm_count), ldr


def _flash_bwd_dq_cuda(q_pre, k, v, g, lse, dl, qm, km, block_rows: int = None):
    """K5: dq (B, Lq, H, D) in q's dtype, without the ln 2 factor.
    q_pre, k, v, g: (B, L, H, D) views (D contiguous), g zeroed on padded
    queries; lse, dl (B, H, Lq) fp32; qm, km (B, L) fp32.  ``block_rows``
    (bf16 only) overrides the tile height ``bwd_tile_rows`` picks."""
    q_pre, k, v, g = _cuda_bwd_operands(q_pre, k, v, g, lse, dl, qm, km)
    B, Lq, H, D = q_pre.shape
    dev, dt = q_pre.device, q_pre.dtype
    q_pre, k, v, g, lse, dl, block_rows, ldr = _bwd_launch_operands(q_pre, k, v, g, lse, dl, block_rows, Lq,
                                                                   sm_count(dev) if dt == torch.bfloat16 else 0)
    dq = torch.empty((B, Lq, H, D), dtype=dt, device=dev)
    lib = kernels.library()
    with torch.cuda.device(dev):
        rc = lib.srhep_flash_bwd_dq(
            q_pre.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(), dl.data_ptr(),
            qm.data_ptr(), km.data_ptr(), dq.data_ptr(),
            B, H, Lq, k.shape[1], D, *_strides(q_pre, k, v, g),
            int(dt == torch.bfloat16), block_rows, ldr, torch.cuda.current_stream(dev).cuda_stream,
        )
    kernels.check(rc, "flash_bwd_dq")
    kernels.LAUNCHES["flash_bwd_dq"] += 1
    return dq


def _flash_bwd_dkv_cuda(q_pre, k, v, g, lse, dl, qm, km, block_rows: int = None):
    """K6: dk, dv (B, Lk, H, D) in k's dtype, dk without the ln 2 factor;
    ``block_rows`` (bf16) as for dq, over the keys."""
    q_pre, k, v, g = _cuda_bwd_operands(q_pre, k, v, g, lse, dl, qm, km)
    B, Lq, H, D = q_pre.shape
    Lk = k.shape[1]
    dev, dt = q_pre.device, q_pre.dtype
    q_pre, k, v, g, lse, dl, block_rows, ldr = _bwd_launch_operands(q_pre, k, v, g, lse, dl, block_rows, Lk,
                                                                   sm_count(dev) if dt == torch.bfloat16 else 0)
    dk = torch.empty((B, Lk, H, D), dtype=dt, device=dev)
    dv = torch.empty((B, Lk, H, D), dtype=dt, device=dev)
    lib = kernels.library()
    with torch.cuda.device(dev):
        rc = lib.srhep_flash_bwd_dkv(
            q_pre.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(), dl.data_ptr(),
            qm.data_ptr(), km.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, H, Lq, Lk, D, *_strides(q_pre, k, v, g),
            int(dt == torch.bfloat16), block_rows, ldr, torch.cuda.current_stream(dev).cuda_stream,
        )
    kernels.check(rc, "flash_bwd_dkv")
    kernels.LAUNCHES["flash_bwd_dkv"] += 1
    return dk, dv


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------


def _heads_first(*ts):
    """(B, L, H, D) -> (B, H, L, D) views, the plain versions' layout."""
    return tuple(t.permute(0, 2, 1, 3) for t in ts)


def _flash_bwd(q_pre, k, v, qm, km, out, lse, g):
    """Backward of the pre-scaled attention in (B, L, H, D) layout (the JAX
    package's ``_flash_bwd``): zero the cotangent on padded queries, dl =
    sum_d(out * g) in fp32, the dq and dk/dv kernels (plain versions on the
    CPU), then the ln 2 of d(exp2 logits)/d(logits) in fp32 and the cast.
    lse (B, H, Lq) fp32; qm (B, Lq), km (B, Lk) fp32.  Returns (dq_pre, dk, dv)."""
    g = g * (qm[:, :, None, None] > 0).to(g.dtype)
    dl = (out.float() * g.float()).sum(-1).transpose(1, 2).contiguous()  # (B, H, Lq)
    if q_pre.is_cuda:
        dq = _flash_bwd_dq_cuda(q_pre, k, v, g, lse, dl, qm, km)
        dk, dv = _flash_bwd_dkv_cuda(q_pre, k, v, g, lse, dl, qm, km)
    else:
        qh, kh, vh, gh = _heads_first(q_pre, k, v, g)
        dq, dk, dv = (t.permute(0, 2, 1, 3) for t in _ref_flash_bwd(qh, kh, vh, gh, lse, dl, km[:, None]))
    dq = (dq.float() * LN2).to(q_pre.dtype)
    dk = (dk.float() * LN2).to(k.dtype)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """Differentiable pre-scaled attention (the JAX package's
    ``_flash_attention`` with its custom VJP).  q_pre, k, v: (B, L, H, D);
    qm (B, Lq), km (B, Lk) fp32 masks.  Forward: the running-max kernel with
    LSE (plain base-2 version on the CPU); backward: ``_flash_bwd``."""

    @staticmethod
    def forward(ctx, q_pre, k, v, qm, km):
        if q_pre.is_cuda:
            out, lse = _flash_fwd_cuda(q_pre, k, v, qm, km, nomax=False, with_lse=True)
        else:
            out, lse = _ref_attention_base2(*_heads_first(q_pre, k, v), qm[:, None], km[:, None], "max", with_lse=True)
            out = out.permute(0, 2, 1, 3)
        ctx.save_for_backward(q_pre, k, v, qm, km, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        q_pre, k, v, qm, km, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q_pre, k, v, qm, km, out, lse, g)
        return dq, dk, dv, None, None


def _attend_pre(q_pre, k, v, qm, km, softmax: str, with_lse: bool = False):
    """Attention on pre-scaled (B, L, H, D) views: the differentiable
    Function when a gradient is needed, else one forward launch (or its
    plain version on the CPU).  Returns (out (B, Lq, H, D), lse or None)."""
    nomax = softmax == "nomax_clip"
    if kernels.needs_grad(q_pre, k, v):
        if nomax:
            raise RuntimeError("the no-max attention kernel is inference-only and not differentiable")
        if with_lse:
            raise ValueError("with_lse is a forward-only option")
        return _FlashAttention.apply(q_pre, k, v, qm, km), None
    if q_pre.is_cuda:
        return _flash_fwd_cuda(q_pre, k, v, qm, km, nomax=nomax, with_lse=with_lse)
    res = _ref_attention_base2(*_heads_first(q_pre, k, v), qm[:, None], km[:, None], softmax, with_lse=with_lse)
    out, lse = res if with_lse else (res, None)
    return out.permute(0, 2, 1, 3), lse


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

    softmax='max': online softmax with a running max, exact for any logits,
    differentiable (``_FlashAttention``): the training path.
    softmax='nomax_clip': inference-only clipped exp2 without the max chain;
    validate per checkpoint with ``nomax_selfcheck`` before trusting it; a
    gradient through it raises.

    CUDA tensors go through the kernels and must pass ``flash_shapes_ok``
    (callers gate on it, as in the JAX package); on the CPU, shapes that pass
    take the plain versions of the kernels and other shapes the dense
    natural-base formulation (the JAX package's einsum fallback).
    """
    B, Lq, H, D = q.shape
    Lk = k.shape[1]
    qm = _float_mask(q_valid, B, Lq, q.device)
    km = _float_mask(kv_valid, B, Lk, q.device)
    if not flash_shapes_ok(Lq, Lk, D):
        if q.is_cuda:
            raise ValueError(
                f"masked_flash_attention: shape (Lq={Lq}, Lk={Lk}, D={D}) fails the flash-kernel "
                f"gate (128-aligned L, D%8==0); gate on flash_shapes_ok and use the einsum path"
            )
        out, _ = _ref_attention(*_heads_first(q, k, v), qm[:, None], km[:, None], scale)
        return out.permute(0, 2, 1, 3)
    # fold the softmax scale and the base-2 conversion into Q (a constant of
    # q's dtype, as JAX casts it); autograd chains d/dq through the product
    q_pre = q * torch.tensor(scale * LOG2E, dtype=q.dtype, device=q.device)
    out, _ = _attend_pre(q_pre, k, v, qm, km, softmax)
    return out


def masked_flash_attention_T(qT_pre, kT, vT, q_valid, kv_valid, softmax: str = "max", with_lse: bool = False):
    """Transposed-layout entry: qT_pre/kT/vT (B, H, D, L) with the softmax
    scale and base-2 conversion ALREADY folded into qT_pre (the fused
    LN+modulate+QKV prologue emits exactly this).  Returns outT (B, H, D, Lq)
    (a transposed view of a (B, Lq, H, D) buffer); with ``with_lse`` (no
    gradient) also the base-2 log-sum-exp (B, H, 1, Lq) fp32.  Differentiable
    with softmax='max'."""
    B, H, D, Lq = qT_pre.shape
    Lk = kT.shape[3]
    qm = _float_mask(q_valid, B, Lq, qT_pre.device)
    km = _float_mask(kv_valid, B, Lk, qT_pre.device)
    if qT_pre.is_cuda and not flash_shapes_ok(Lq, Lk, D):
        raise ValueError(f"masked_flash_attention_T: shape (Lq={Lq}, Lk={Lk}, D={D}) fails flash_shapes_ok")
    q, k, v = (t.permute(0, 3, 1, 2) for t in (qT_pre, kT, vT))  # (B, L, H, D) views
    out, lse = _attend_pre(q, k, v, qm, km, softmax, with_lse=with_lse)
    outT = out.permute(0, 2, 3, 1)
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
