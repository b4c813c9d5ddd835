"""The arithmetic of the fp32 attention kernels on Hopper's tensor cores
(``csrc/tf32_attention.cuh``: K1/K2/K7, K5/K8 and K6/K9 on fp32 operands),
stated in PyTorch so that the CPU tests can hold it against the JAX package.

Each fp32 operand x of a product is split into two TF32 values, hi =
rna(x) and lo = rna(x - hi) (``tf32_round`` is ``cvt.rna.tf32.f32``), and
each product is taken as lo*hi + hi*lo + hi*hi, accumulated in fp32 over
8-deep steps (one ``mma.sync.m16n8k8`` each), smallest terms first: about
2^-21 of relative error a product.  With ``terms=1`` only hi*hi is kept:
the single TF32 product (~2^-11), which the tests show the kernels' fp32
checks can see.

The summed axis is read in the kernels' order: in the forward's S = Q K^T
the head dim is permuted within 16-column groups (k-step 2m reads columns
16m + {0, 1, 4, 5, 8, 9, 12, 13}, k-step 2m + 1 the others), and in every
product whose A operand comes from an accumulator (P V, P^T G, dS^T Q, dS K) the
keys or queries within each 8-wide step are read as (0, 2, 4, 6, 1, 3, 5,
7).  The online softmax runs over 64-key tiles as the kernel's (from D = 32
in two passes of 32 keys each), and key (query) tiles without a cell the
block attends are skipped; the output is
O * (1 / max(l, 1e-30)), as the kernel's epilogue takes it.  The long sums
(O, dQ, dK, dV) take the split products of each 8-deep step in a fresh
accumulator and add it to the running one (``fresh=1``), as the kernels do:
the tensor cores round an mma's sum toward zero, and over a long chain into
one accumulator that bias adds up (``csrc/tf32_attention.cuh``).

These functions are plain versions for tests only; the wrappers' plain
versions (``flash_attention._ref_*``) are what a CPU tensor computes.
"""

from __future__ import annotations

import torch

from .flash_attention import BIG, CLIP_HI, CLIP_LO

PAD_SEG = -1  # segment id of padding cells (flash_packed.PAD_SEG)

TILE = 64  # rows of a block and of a streamed tile (keys in the forward and dq, queries in dk/dv)
STEP = 8   # depth of one m16n8k8 product
FWD_PASS = {16: 64}  # keys a softmax pass of the forward takes, by head dim (else 32)

# the summed axis as the kernels read it (see the module docstring)
_ACC_STEP_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)
_QK_GROUP_ORDER = (0, 1, 4, 5, 8, 9, 12, 13, 2, 3, 6, 7, 10, 11, 14, 15)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` on fp32 values by integer operations on their
    bits: the 23-bit mantissa rounded to 10 bits, to nearest with ties away
    from zero (add half of the dropped range to the magnitude's bits, clear
    the low 13 bits; a carry moves into the exponent and may reach inf);
    subnormals round the same way; inf stays inf and NaN stays NaN."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    finite = (b & 0x7F800000) != 0x7F800000
    keep = ~0x1FFF  # clears the 13 low mantissa bits
    rounded = (b + 0x1000) & keep
    nan = (~finite) & ((b & 0x007FFFFF) != 0)
    special = torch.where(nan, (b | 0x00400000) & keep, b)  # a NaN keeps a mantissa bit
    return torch.where(finite, rounded, special).view(torch.float32)


def split(x: torch.Tensor):
    """(hi, lo) TF32 values with hi + lo == x up to ~2^-22 relative."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def _step_perm(n: int, group) -> torch.Tensor:
    """A permutation of range(n) that reorders each ``len(group)``-wide group."""
    g = len(group)
    return torch.tensor([base + o for base in range(0, n, g) for o in group])


def split_matmul(a: torch.Tensor, b: torch.Tensor, terms: int = 3, perm=None, acc=None, fresh: int = 0):
    """``acc`` (zeros if None) + a (..., M, K) @ b (..., K, N) in fp32 as
    the kernels take it: the summed axis reordered by ``perm``, then 8-deep
    steps in order, each the split products lo*hi, hi*lo, hi*hi (or hi*hi
    alone, ``terms=1``) added to the fp32 accumulator one after the other,
    or, with ``fresh`` = n, those of n steps at a time summed from zero and
    then added to it."""
    if terms not in (1, 3):
        raise ValueError("a split product has one term or three")
    if perm is not None:
        a, b = a[..., perm], b[..., perm, :]
    ah, al = split(a)
    bh, bl = split(b)
    if acc is None:
        acc = torch.zeros((*torch.broadcast_shapes(a.shape[:-2], b.shape[:-2]), a.shape[-2], b.shape[-1]))
    group = STEP * max(fresh, 1)
    for g0 in range(0, a.shape[-1], group):
        part = torch.zeros_like(acc) if fresh else acc
        for k0 in range(g0, min(g0 + group, a.shape[-1]), STEP):
            s = slice(k0, k0 + STEP)
            if terms == 3:
                part = part + al[..., s] @ bh[..., s, :]
                part = part + ah[..., s] @ bl[..., s, :]
            part = part + ah[..., s] @ bh[..., s, :]
        acc = acc + part if fresh else part
    return acc


def flash_fwd_split(q_pre, k, v, qm, km, softmax: str = "max", with_lse: bool = False, terms: int = 3):
    """The fp32 forward kernel's arithmetic (K1/K2): (B, H, L, D) fp32
    operands, q pre-scaled to base-2 logits; qm (B, 1, Lq), km (B, 1, Lk)
    float masks, as ``flash_attention._ref_attention_base2`` takes them.
    Key tiles of 64 without a valid key are skipped; the running max,
    p = exp2(s - m) (robust; masked logits -1e30) or exp2(clip(s)) (no-max,
    masked p = 0), the rescale, O += P V; out = O / max(l, 1e-30) with padded
    query rows 0; LSE m + log2(max(l, 1e-30))."""
    B, H, Lq, D = q_pre.shape
    Lk = k.shape[2]
    valid_k = km[:, 0] > 0  # (B, Lk)
    qk_perm = _step_perm(D, _QK_GROUP_ORDER)
    m = torch.full((B, H, Lq, 1), -BIG)
    l = torch.zeros((B, H, Lq, 1))
    o = torch.zeros((B, H, Lq, D))
    passes = [(k0, p0) for k0 in range(0, Lk, TILE) for p0 in range(k0, min(k0 + TILE, Lk), FWD_PASS.get(D, 32))]
    for k0, p0 in passes:
        live = valid_k[:, k0:k0 + TILE].any(-1)  # (B,): the kernel's 64-key tile flag, per batch row
        if not bool(live.any()):
            continue
        kt = slice(p0, min(p0 + FWD_PASS.get(D, 32), k0 + TILE, Lk))
        s = split_matmul(q_pre, k[:, :, kt].transpose(-1, -2), terms, qk_perm)
        keep = valid_k[:, None, None, kt]
        if softmax == "nomax_clip":
            p = torch.where(keep, torch.exp2(s.clamp(CLIP_LO, CLIP_HI)), torch.zeros(()))
            al = torch.ones_like(m)
        else:
            s = torch.where(keep, s, torch.full((), -BIG))
            mn = torch.maximum(m, s.amax(-1, keepdim=True))
            al = torch.exp2(m - mn)
            p = torch.exp2(s - mn)
            m = torch.where(live[:, None, None, None], mn, m)
            al = torch.where(live[:, None, None, None], al, torch.ones(()))
        p = torch.where(live[:, None, None, None], p, torch.zeros(()))
        n = kt.stop - kt.start
        l = l * al + p.sum(-1, keepdim=True)
        o = split_matmul(p, v[:, :, kt], terms, _step_perm(n, _ACC_STEP_ORDER) if n % STEP == 0 else None, o * al,
                         fresh=1)
    out = o * torch.where((qm[:, 0, :, None] > 0)[:, None], 1.0 / l.clamp_min(1e-30), torch.zeros(()))
    if with_lse:
        return out, (m + torch.log2(l.clamp_min(1e-30))).squeeze(-1)
    return out


def flash_bwd_dkv_split(q_pre, k, v, g, lse, dl, km, terms: int = 3):
    """The fp32 dk/dv kernel's arithmetic (K6, dk without ln 2): (B, H, L, D)
    fp32 operands, g zeroed on padded queries, lse/dl (B, H, Lq), km
    (B, 1, Lk), as ``flash_attention._ref_flash_bwd_dkv`` takes them.  Query
    tiles of 64 in order; S^T = K Q^T and dP^T = V G^T (head dim in natural
    order), p = exp2(min(s - lse, 0)) with padded keys' logits -1e30,
    dS^T = P^T (dP^T - dl), dV += P^T G, dK += dS^T Q; padded key rows 0."""
    B, H, Lq, D = q_pre.shape
    Lk = k.shape[2]
    keep = km[:, 0, None, :, None] > 0  # (B, 1, Lk, 1): key rows
    dk = torch.zeros((B, H, Lk, D))
    dv = torch.zeros((B, H, Lk, D))
    for q0 in range(0, Lq, TILE):
        qt = slice(q0, min(q0 + TILE, Lq))
        n = qt.stop - qt.start
        perm = _step_perm(n, _ACC_STEP_ORDER) if n % STEP == 0 else None
        st = split_matmul(k, q_pre[:, :, qt].transpose(-1, -2), terms)
        dpt = split_matmul(v, g[:, :, qt].transpose(-1, -2), terms)
        st = torch.where(keep, st, torch.full((), -BIG))
        p = torch.exp2(torch.clamp_max(st - lse[:, :, None, qt], 0.0))
        ds = p * (dpt - dl[:, :, None, qt])
        dv = split_matmul(p, g[:, :, qt], terms, perm, dv, fresh=1)
        dk = split_matmul(ds, q_pre[:, :, qt], terms, perm, dk, fresh=1)
    return torch.where(keep, dk, torch.zeros(())), torch.where(keep, dv, torch.zeros(()))


def flash_bwd_dq_split(q_pre, k, v, g, lse, dl, km, seg=None, terms: int = 3):
    """The fp32 dq kernel's arithmetic (K5; K8 with ``seg``; dq without ln 2):
    (B, H, L, D) fp32 operands, g zeroed on padded queries, lse/dl (B, H, Lq),
    km (B, 1, Lk) float mask, as ``flash_attention._ref_flash_bwd_dq`` takes
    them, or seg (B, S) segment ids (``PAD_SEG`` on padding; km unused), as
    ``flash_packed._ref_packed_bwd_dq``.  A block of 64 queries visits the
    key tiles of 64, in order, that hold a key it attends (padding masks: a
    valid key; segments: a key whose id lies between the smallest and the
    largest id of the block's valid queries); S = Q K^T and dP = G V^T (head
    dim in natural order), p = exp2(min(s - lse, 0)) with the logits of the
    other keys -1e30, dS = P (dP - dl), dQ += dS K (keys permuted within
    8-wide steps, each step summed apart); padding rows 0 (with padding
    masks the zero cotangent gives them 0)."""
    B, H, Lq, D = q_pre.shape
    Lk = k.shape[2]
    if seg is None:
        qid = torch.zeros((B, Lq), dtype=torch.int64)
        kid = torch.where(km[:, 0] > 0, 0, -2)  # (B, Lk): a padded key attends nothing
        qvalid = torch.ones((B, Lq), dtype=torch.bool)  # the keys alone decide a tile's flag
    else:
        qid = kid = seg.long()
        qvalid = seg != PAD_SEG
    # the id range of each block's valid queries, per query row: (B, Lq)
    big = torch.iinfo(torch.int64).max
    nb = (Lq + TILE - 1) // TILE
    pad_rows = nb * TILE - Lq
    blocks = torch.nn.functional.pad(torch.where(qvalid, qid, big), (0, pad_rows), value=big).view(B, nb, TILE)
    lo = blocks.amin(-1).repeat_interleave(TILE, -1)[:, :Lq]
    blocks = torch.nn.functional.pad(torch.where(qvalid, qid, -big), (0, pad_rows), value=-big).view(B, nb, TILE)
    hi = blocks.amax(-1).repeat_interleave(TILE, -1)[:, :Lq]
    dq = torch.zeros((B, H, Lq, D))
    for k0 in range(0, Lk, TILE):
        kt = slice(k0, min(k0 + TILE, Lk))
        n = kt.stop - kt.start
        ids = kid[:, kt]  # (B, n)
        live = ((ids[:, None, :] >= lo[:, :, None]) & (ids[:, None, :] <= hi[:, :, None])).any(-1)  # (B, Lq)
        if not bool(live.any()):
            continue
        s = split_matmul(q_pre, k[:, :, kt].transpose(-1, -2), terms)
        dp = split_matmul(g, v[:, :, kt].transpose(-1, -2), terms)
        s = torch.where((qid[:, :, None] == ids[:, None, :])[:, None], s, torch.full((), -BIG))
        p = torch.exp2(torch.clamp_max(s - lse[..., None], 0.0))
        ds = torch.where(live[:, None, :, None], p * (dp - dl[..., None]), torch.zeros(()))
        perm = _step_perm(n, _ACC_STEP_ORDER) if n % STEP == 0 else None
        dq = split_matmul(ds, k[:, :, kt], terms, perm, dq, fresh=1)
    return torch.where(qvalid[:, None, :, None], dq, torch.zeros(()))
