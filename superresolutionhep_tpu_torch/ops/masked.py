"""Masked primitives for variable-length sets padded to static shapes.

Convention (everywhere in this package, as in the JAX package):
**mask == True means VALID**.  Denominators are guarded so fully padded rows
(possible with bucketed batching) yield zeros rather than NaN.
"""

from __future__ import annotations

import torch

from ..parallel.comm import all_reduce_sum, psum

NEG_INF = -1e30  # large-but-finite: keeps softmax well-defined for all-pad rows


def masked_softmax(x, valid_mask, axis: int = -1):
    """Softmax over ``axis`` that ignores padded entries and re-zeros them
    afterwards.  valid_mask broadcasts against x (extra dims added after the
    batch dim as needed)."""
    if valid_mask is None:
        return _softmax(x, axis)
    mask = _broadcast_mask(valid_mask, x.ndim)
    x = torch.where(mask, x, torch.full((), NEG_INF, dtype=x.dtype, device=x.device))
    out = _softmax(x, axis)
    return torch.where(mask, out, torch.zeros((), dtype=out.dtype, device=out.device))


def _softmax(x, axis):
    x = x - x.amax(dim=axis, keepdim=True)
    e = torch.exp(x)
    return e / e.sum(dim=axis, keepdim=True).clamp_min(1e-30)


def _broadcast_mask(mask, ndim):
    """Left-pad mask shape after the batch dim until it has `ndim` dims."""
    while mask.ndim < ndim:
        mask = mask[:, None, ...]
    return mask


def merge_masks(q_valid, kv_valid, attn_valid, q_len: int, k_len: int):
    """Combine padding masks and an optional adjacency mask into a single
    (B, Lq, Lk) valid mask (True = attend).  Any input may be None; returns
    None if all are None."""
    merged = None
    if q_valid is not None or kv_valid is not None:
        if q_valid is None:
            q_valid = torch.ones((kv_valid.shape[0], q_len), dtype=torch.bool, device=kv_valid.device)
        if kv_valid is None:
            kv_valid = torch.ones((q_valid.shape[0], k_len), dtype=torch.bool, device=q_valid.device)
        merged = q_valid[..., :, None] & kv_valid[..., None, :]
    if attn_valid is not None:
        merged = attn_valid if merged is None else (attn_valid & merged)
    return merged


def masked_mean(x, valid_mask, axis: int = 1, group=None):
    """Mean over ``axis`` counting only valid entries; guarded denominator
    (fully padded filler events in a bucket batch divide by 1, not 0).

    ``group``: the sequence-parallel process group when ``axis`` is sharded
    over it: numerator and denominator are summed over the group (the
    numerator with the all-reduce backward, ``parallel/comm.py::psum``)."""
    m = valid_mask.to(x.dtype)
    while m.ndim < x.ndim:
        m = m[..., None]
    num = (x * m).sum(dim=axis)
    den = m.sum(dim=axis)
    if group is not None:
        num, den = psum(num, group), all_reduce_sum(den, group)
    return num / den.clamp_min(1.0)


def attach_context(x, context):
    """Broadcast-concatenate a lower-rank context onto x's feature axis.
    Mixed dtypes promote as ``torch.cat`` promotes (fp32 wins over bf16)."""
    if context is None:
        raise ValueError("expected context is missing")
    if x.ndim < context.ndim:
        raise ValueError(f"context rank {context.ndim} exceeds input rank {x.ndim}")
    while context.ndim < x.ndim:
        context = context[:, None, ...]
    context = context.expand(*x.shape[:-1], context.shape[-1])
    return torch.cat([x, context], dim=-1)


def segment_onehot(seg, n_seg: int, dtype):
    """(B, S) segment ids -> (B, S, n_seg) one-hot; pad cells (seg == -1)
    are all-zero rows.  The packed path's gather/scatter: both the
    per-segment reduction and the per-cell broadcast are (S x n_seg)
    products."""
    return (seg[..., None] == torch.arange(n_seg, device=seg.device)[None, None, :]).to(dtype)


def segment_table(per_segment):
    """(B, E, F) per-segment rows -> (B, E + 1, F): row E is the zero row,
    the one a padding cell gets (its one-hot row is all zeros)."""
    B, _, F = per_segment.shape
    return torch.cat([per_segment, per_segment.new_zeros(B, 1, F)], dim=1)


def segment_index(seg, n_seg: int):
    """(B, S) segment ids -> row indices into a ``segment_table``: the id for
    0 <= id < n_seg, else n_seg (the zero row), as ``segment_onehot`` gives
    an all-zero row to every id outside [0, n_seg)."""
    return torch.where((seg >= 0) & (seg < n_seg), seg, n_seg).long()


def gather_segment_rows(table, seg):
    """Per-cell rows (B, S, F) from a ``segment_table`` (B, E + 1, F): each
    cell's segment row by a gather.  For finite rows this equals the one-hot
    product ``einsum("bse,bef->bsf", segment_onehot(seg, E), rows)`` bit for
    bit (one exact 1 times the row, plus exact zeros); it differs only where
    a row holds inf or nan, which the product spreads over every cell."""
    idx = segment_index(seg, table.shape[1] - 1)
    return torch.gather(table, 1, idx[..., None].expand(-1, -1, table.shape[-1]))


def segment_mean(x, onehot):
    """Per-segment mean of ``x`` (B, S, C) given a segment_onehot (B, S, E):
    returns (B, E, C); empty segments are zero."""
    num = torch.einsum("bse,bsc->bec", onehot, x)
    den = onehot.sum(dim=1)  # (B, E)
    return num / den.clamp_min(1.0)[..., None]
