"""Masked multi-head attention over padded variable-length sets.

Counterpart of the JAX package's ``models/attention.py``: self- and
cross-attention with padding masks, self-attention over segment-packed rows,
and the general path: per-edge features (an additive bias ``E`` from
``linear_e`` and a sigmoid gate ``G`` from ``linear_g``, optional edge
updates ``linear_e_out`` from the raw scores), an additive ``attn_bias``, an
adjacency mask ``attn_valid`` merged into the padding masks, and dropout on
the raw scores before the softmax (the reference's quirk).

Sequence and tensor parallelism, as in the JAX package:

  * ``sp_group``: the token axis arrives sharded over this process group;
    the projected keys, values and key mask are gathered
    (``sp_mode='gather'``; the flash kernel then runs with local queries
    against all keys, Lq != Lk) or rotated round the group with an online
    softmax (``sp_mode='ring'``, ops/ring_attention.py; padding masks only)
    while the queries stay local.  Segment packing is refused under it;
  * ``tp_group``: this module holds a head slice — ``embed_dim`` and
    ``num_heads`` are the LOCAL counts, ``q_dim`` the model width.  Q/K/V
    are column-parallel behind Megatron's ``f``, the output projection
    row-parallel with its partial products summed by ``g`` (ops/tp.py); the
    caller shards the weights and divides the output bias by the group size
    (parallel/tp.py).  It needs the output projection and refuses edge
    features and score dropout;
  * the fused prologue is refused under either.

  * the JAX package's rule ``_can_use_flash`` decides where a flash kernel
    may be taken: only without edges, bias, adjacency mask, edge updates and
    score dropout.  The general path is the dense formulation, on the CPU and
    the card alike;
  * cross-attention (``k`` given, ``v`` defaults to ``k``, ``kv_valid`` the
    keys' mask; Lq may differ from Lk) takes the flash kernel when
    ``flash_shapes_ok(Lq, Lk, D)`` holds and the dense formulation otherwise,
    as in the JAX package: the PF kinematics cross-attention (4 particle
    queries) is dense by design;
  * mask convention: True == valid (see ops/masked.py);
  * ``segment_ids`` (B, L) int, -1 on padding: several events packed into
    one row attend only within their own segment (ops/flash_packed.py).  On
    a CUDA tensor this is always the packed kernel (``impl`` picks its
    softmax); the dense block-diagonal formulation is taken only on the CPU;
  * ``impl``: 'flash' (running-max kernel) | 'flash_nomax' (inference-only
    clipped-exp2 kernel) | 'einsum' (dense scores) | 'auto' (flash when the
    tensor is on CUDA, einsum on the CPU); a shape takes a kernel only where
    both the JAX package's gate and the kernel's capacity gate admit it
    (``flash_kernel_ok``, ``fused_qkv_capacity_ok``), else the dense or
    unfused formulation, on the CPU and the card alike;
  * ``fused_ln=(eff_a, eff_b)``: the input arrives RAW (pre-norm) and
    LayerNorm + adaLN modulate + the QKV projections run as one kernel
    (ops/fused_qkv.py) straight into the flash kernel's layout; with
    ``segment_ids`` the rows are per-segment tables (B, E + 1, F);
  * score dropout acts in training mode only (``module.train()``, the JAX
    package's ``deterministic=False``); its keep mask is drawn from the
    ``dropout_generator`` passed to ``forward``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from ..ops.flash_attention import (
    LOG2E,
    flash_kernel_ok,
    flash_shapes_ok,
    masked_flash_attention,
    masked_flash_attention_T,
)
from ..ops.flash_packed import packed_flash_attention, packed_flash_attention_T, packed_shapes_ok
from ..ops.fused_qkv import _ln_noaffine, cell_rows, fused_ln_mod_proj, fused_qkv_capacity_ok, fused_qkv_ok
from ..ops.masked import masked_softmax, merge_masks
from ..ops.ring_attention import ring_masked_attention
from ..ops.tp import tp_allreduce, tp_block_input
from ..parallel.comm import all_gather
from .dense import Linear, xavier_uniform_

IMPLS = ("flash", "flash_nomax", "einsum", "auto")
SP_MODES = ("gather", "ring")


def _can_use_flash(edges, attn_bias, attn_valid, update_edges, dropout) -> bool:
    """The JAX package's rule: a flash kernel computes padding-masked
    attention only."""
    return edges is None and attn_bias is None and attn_valid is None and not update_edges and dropout == 0.0


def score_dropout(scores, rate: float, generator=None):
    """Flax ``nn.Dropout`` on the raw scores: each kept with probability
    1 - rate and scaled by 1 / (1 - rate), the others set to 0 (before the
    softmax, so a dropped score weighs exp(0), not nothing)."""
    keep = torch.rand(scores.shape, generator=generator, device=scores.device) < 1.0 - rate
    return torch.where(keep, scores / (1.0 - rate), torch.zeros((), dtype=scores.dtype, device=scores.device))


class MultiheadAttention(nn.Module):
    def __init__(
        self,
        embed_dim: int,
        num_heads: int,
        q_dim: Optional[int] = None,
        out_proj: bool = True,
        dropout: float = 0.0,
        impl: str = "auto",
        dtype=None,
        edge_embed_dim: int = 0,
        update_edges: bool = False,
        sp_group=None,
        sp_mode: str = "gather",
        tp_group=None,
    ):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} not divisible by {num_heads} heads")
        if edge_embed_dim % num_heads:
            raise ValueError("edge_embed_dim must be divisible by num_heads")
        if impl not in IMPLS:
            raise ValueError(f"unknown attention impl {impl!r}; one of {IMPLS}")
        if sp_mode not in SP_MODES:
            raise ValueError(f"unknown sp_mode {sp_mode!r}; one of {SP_MODES}")
        if tp_group is not None:
            if not out_proj:
                raise ValueError("tp_group requires out_proj (row-parallel reduce point)")
            if edge_embed_dim > 0:
                raise ValueError("tp_group does not support edge features")
            if dropout > 0.0:
                raise ValueError("tp_group: score dropout would desync shards")
        self.sp_group, self.sp_mode, self.tp_group = sp_group, sp_mode, tp_group
        self.embed_dim, self.num_heads, self.impl = embed_dim, num_heads, impl
        self.dropout, self.update_edges = float(dropout), bool(update_edges)
        in_dim = q_dim or embed_dim
        self.linear_q = xavier_uniform_(Linear(in_dim, embed_dim, dtype=dtype))
        self.linear_k = xavier_uniform_(Linear(in_dim, embed_dim, dtype=dtype))
        self.linear_v = xavier_uniform_(Linear(in_dim, embed_dim, dtype=dtype))
        if edge_embed_dim:
            self.linear_e = xavier_uniform_(Linear(edge_embed_dim, num_heads, dtype=dtype))
            self.linear_g = xavier_uniform_(Linear(edge_embed_dim, num_heads, dtype=dtype))
            if update_edges:
                self.linear_e_out = xavier_uniform_(Linear(num_heads, edge_embed_dim, dtype=dtype))
        self.linear_out = xavier_uniform_(Linear(embed_dim, in_dim, dtype=dtype)) if out_proj else None
        self._fold = None  # cached (version key, w (F, 3F) view, bias) of the fused path, grad disabled

    # ------------------------------------------------------------------
    def _use_flash(self, x) -> bool:
        """'flash'/'flash_nomax' always; 'auto' when the tensor is on CUDA
        (the counterpart of the JAX package's backend test)."""
        return self.impl in ("flash", "flash_nomax") or (self.impl == "auto" and x.is_cuda)

    @property
    def _softmax(self) -> str:
        return "nomax_clip" if self.impl == "flash_nomax" else "max"

    def forward(
        self,
        q,
        k=None,
        v=None,
        edges=None,
        q_valid=None,
        kv_valid=None,
        attn_valid=None,
        attn_bias=None,
        segment_ids=None,
        fused_ln=None,
        dropout_generator=None,
    ):
        """q: (B, Lq, F); k, v: (B, Lk, F) for cross-attention (v defaults to
        k).  Masks are True==valid; ``attn_valid`` (B, Lq, Lk) and
        ``attn_bias`` / ``edges`` (B, Lq, Lk, H / edge_embed_dim).  Returns
        (B, Lq, q_dim or embed_dim); with ``edges`` given, (out, edge_out),
        edge_out (B, Lq, Lk, edge_embed_dim) or None without edge updates."""
        general = not _can_use_flash(edges, attn_bias, attn_valid, self.update_edges, self.dropout)
        if fused_ln is not None:
            if k is not None or v is not None or edges is not None or attn_bias is not None \
                    or attn_valid is not None or (self.dropout and self.training) \
                    or self.sp_group is not None or self.tp_group is not None:
                raise ValueError("fused_ln supports padding-masked self-attention only "
                                 "(no k/v, edges, attn_bias/valid, sp_group, tp_group or active dropout)")
            return self._fused_self_attention(q, q_valid, fused_ln, segment_ids)
        if segment_ids is not None and self.sp_group is not None:
            raise NotImplementedError("segment packing and sequence parallelism are exclusive")
        if self.tp_group is not None:
            # Megatron f at the column-parallel Q/K/V entry, before the k = q
            # aliasing, so that one boundary covers all three projections
            q = tp_block_input(q, self.tp_group)
            k = tp_block_input(k, self.tp_group) if k is not None else None
            v = tp_block_input(v, self.tp_group) if v is not None else None
        if k is None:
            k = q
            if kv_valid is None:
                kv_valid = q_valid
        elif segment_ids is not None:
            raise ValueError("segment_ids are a self-attention option; cross-attention takes padding masks")
        if v is None:
            v = k

        B, Lq, _ = q.shape
        Lk = k.shape[1]
        H, HD = self.num_heads, self.embed_dim // self.num_heads

        q_p = self.linear_q(q).reshape(B, Lq, H, HD)
        k_p = self.linear_k(k).reshape(B, Lk, H, HD)
        v_p = self.linear_v(v).reshape(B, Lk, H, HD)
        if self.sp_group is not None and self.sp_mode == "ring":
            if edges is not None or attn_bias is not None or attn_valid is not None:
                raise NotImplementedError("ring attention supports padding masks only")
            out = ring_masked_attention(q_p, k_p, v_p, q_valid, kv_valid, 1.0 / math.sqrt(HD), self.sp_group)
            return self._project_out(out.reshape(B, Lq, self.embed_dim))
        if self.sp_group is not None:
            # gather the sharded token axis of keys, values and their mask;
            # the queries (and the output's token axis) stay local
            k_p, v_p = all_gather(k_p, self.sp_group), all_gather(v_p, self.sp_group)
            kv_valid = all_gather(kv_valid, self.sp_group)
        if general:
            if segment_ids is not None:
                raise ValueError("segment packing supports padding masks only")
            return self._attend_general(q_p, k_p, v_p, q_valid, kv_valid, attn_valid, attn_bias, edges,
                                        dropout_generator)
        return self._project_out(self._attend(q_p, k_p, v_p, q_valid, kv_valid, segment_ids))

    def _attend_general(self, q_p, k_p, v_p, q_valid, kv_valid, attn_valid, attn_bias, edges, generator):
        """The dense formulation with the edge bias and gate, the additive
        bias, the adjacency mask and the score dropout (JAX
        ``models/attention.py``, the path past ``_can_use_flash``)."""
        B, Lq, H, HD = q_p.shape
        Lk = k_p.shape[1]
        g = None
        if edges is not None:
            e = self.linear_e(edges)  # (B, Lq, Lk, H)
            attn_bias = e if attn_bias is None else attn_bias + e
            g = torch.sigmoid(self.linear_g(edges))
        mask = merge_masks(q_valid, kv_valid, attn_valid, Lq, Lk)
        scores = torch.einsum("bqhd,bkhd->bhqk", q_p, k_p) / math.sqrt(HD)
        if attn_bias is not None:  # (B, Lq, Lk, H) -> (B, H, Lq, Lk)
            scores = scores + attn_bias.permute(0, 3, 1, 2)
        if self.dropout and self.training:
            scores = score_dropout(scores, self.dropout, generator)
        weights = masked_softmax(scores, mask[:, None] if mask is not None else None, axis=-1)
        if g is not None:
            weights = weights * g.permute(0, 3, 1, 2)
        out = self._project_out(torch.einsum("bhqk,bkhd->bqhd", weights, v_p).reshape(B, Lq, self.embed_dim))
        if edges is None:
            return out
        edge_out = self.linear_e_out(scores.permute(0, 2, 3, 1)) if self.update_edges else None
        return out, edge_out

    def _attend(self, q_p, k_p, v_p, q_valid, kv_valid, segment_ids=None):
        """(B, Lq, H, HD) queries, (B, Lk, H, HD) keys and values ->
        (B, Lq, embed_dim)."""
        B, Lq, H, HD = q_p.shape
        Lk = k_p.shape[1]
        scale = math.sqrt(HD)  # scores are DIVIDED by it
        attn_valid = None
        if segment_ids is not None:
            if q_p.is_cuda or (self._use_flash(q_p) and packed_shapes_ok(Lq, HD)):
                out = packed_flash_attention(q_p, k_p, v_p, segment_ids, scale=1.0 / scale, softmax=self._softmax)
                return out.reshape(B, Lq, self.embed_dim)
            # plain block-diagonal formulation (CPU): same segment, valid key
            attn_valid = (segment_ids[:, :, None] == segment_ids[:, None, :]) & (segment_ids >= 0)[:, None, :]
        elif self._use_flash(q_p) and flash_shapes_ok(Lq, Lk, HD) and flash_kernel_ok(HD):
            out = masked_flash_attention(
                q_p, k_p, v_p, q_valid, kv_valid, scale=1.0 / scale, softmax=self._softmax
            )
            return out.reshape(B, Lq, self.embed_dim)
        mask = merge_masks(q_valid, kv_valid, attn_valid, Lq, Lk)  # (B, Lq, Lk) or None
        scores = torch.einsum("bqhd,bkhd->bhqk", q_p, k_p) / scale
        weights = masked_softmax(scores, mask[:, None] if mask is not None else None, axis=-1)
        return torch.einsum("bhqk,bkhd->bqhd", weights, v_p).reshape(B, Lq, self.embed_dim)

    def _project_out(self, out):
        """Output projection; under tensor parallelism its partial products
        are summed over the group by Megatron's g (the output bias arrives
        divided by the group size, so the sum adds it once)."""
        out = self.linear_out(out) if self.linear_out is not None else out
        return tp_allreduce(out, self.tp_group)

    # ------------------------------------------------------------------
    def _folded_qkv(self):
        """(F, 3F) weight (the transposed view of a (3F, F) buffer) in the
        compute dtype and (3F,) bias in the parameters' dtype, with the flash
        pre-scale scale*log2(e) folded into the Q columns AND the Q bias (the
        fold in the parameters' dtype, then the cast, as in the JAX package).
        Under grad the fold is built with autograd, so that gradients reach
        linear_{q,k,v}.{weight,bias}; with grad disabled it is cached until a
        parameter changes."""
        ps = (self.linear_q.weight, self.linear_k.weight, self.linear_v.weight,
              self.linear_q.bias, self.linear_k.bias, self.linear_v.bias)
        dt = self.linear_q.dtype
        HD = self.embed_dim // self.num_heads
        c = torch.tensor((1.0 / math.sqrt(HD)) * LOG2E, dtype=ps[0].dtype, device=ps[0].device)

        def fold():
            w_t = torch.cat([ps[0] * c, ps[1], ps[2]], dim=0).to(dt)  # (3F, F)
            return w_t.t(), torch.cat([ps[3] * c, ps[4], ps[5]], dim=0)

        if torch.is_grad_enabled() and any(p.requires_grad for p in ps):
            self._fold = None
            return fold()
        key = (dt,) + tuple((p.data_ptr(), p._version, p.dtype, p.device) for p in ps)
        if self._fold is None or self._fold[0] != key:
            self._fold = (key, *fold())
        return self._fold[1], self._fold[2]

    def _fused_self_attention(self, x, valid, fused_ln, segment_ids=None):
        """Fused-prologue self-attention: LN + modulate + QKV in one kernel
        straight into the flash kernel: the padding-masked one, or the
        segment-packed one when ``segment_ids`` is given (eff_a/eff_b are
        then per-segment tables (B, E + 1, F), ``ops/masked.py::
        segment_table``).  Takes an equivalent unfused formulation when a
        shape or capacity gate fails or the impl is not a flash one, so the
        caller never needs a second code path."""
        eff_a, eff_b = fused_ln
        B, L, F = x.shape
        H, HD = self.num_heads, self.embed_dim // self.num_heads
        dt = self.linear_q.dtype
        packed = segment_ids is not None
        kernel_ok = packed_shapes_ok(L, HD) if packed else flash_shapes_ok(L, L, HD) and flash_kernel_ok(HD)

        if self._use_flash(x) and fused_qkv_ok(L, F) and fused_qkv_capacity_ok(F, dt) and kernel_ok:
            w, bias = self._folded_qkv()
            qkvT = fused_ln_mod_proj(x.to(dt), eff_a, eff_b, w, bias, segment_ids=segment_ids)  # (B, 3F, L)
            qkvT = qkvT.reshape(B, 3, H, HD, L)
            if packed:
                outT = packed_flash_attention_T(qkvT[:, 0], qkvT[:, 1], qkvT[:, 2], segment_ids, softmax=self._softmax)
            else:
                outT = masked_flash_attention_T(
                    qkvT[:, 0], qkvT[:, 1], qkvT[:, 2], valid, valid, softmax=self._softmax
                )
            out = outT.permute(0, 3, 1, 2).reshape(B, L, self.embed_dim)
        else:
            xhat = _ln_noaffine(x.float())
            if packed:  # per-segment tables -> per-cell rows
                eff_a, eff_b = cell_rows(eff_a, segment_ids), cell_rows(eff_b, segment_ids)
            a3 = eff_a if eff_a.ndim == 3 else eff_a[:, None, :]
            b3 = eff_b if eff_b.ndim == 3 else eff_b[:, None, :]
            y = (xhat * a3 + b3).to(dt)
            q_p = self.linear_q(y).reshape(B, L, H, HD)
            k_p = self.linear_k(y).reshape(B, L, H, HD)
            v_p = self.linear_v(y).reshape(B, L, H, HD)
            out = self._attend(q_p, k_p, v_p, valid, valid, segment_ids)
        return self._project_out(out)
