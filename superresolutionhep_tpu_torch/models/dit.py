"""Diffusion Transformer (DiT) layers with adaLN conditioning.

Counterpart of the JAX package's ``models/dit.py``: per-layer context ->
SiLU -> Linear -> 6-way (shift/scale/gate for MSA and MLP) modulation; gated
residual attention and FFN.  Self-attention with padding masks or
segment-packed rows, and cross-attention, whose modulation is applied to the
keys.  ``remat``
recomputes each layer in the backward pass (``torch.utils.checkpoint``, the
counterpart of ``nn.remat(DiTLayer)``).

Parallelism, as in the JAX package: ``sp_group``/``sp_mode`` go to the
attention (cells sharded over the group); ``tp_group`` shards the attention
heads and the MLP's hidden width over the group (Megatron), the layer then
building LOCAL widths — ``num_heads``/n heads, ``embed_dim``/n attention
projections, hidden/n MLP — so that the sharded parameters of parallel/tp.py
load into it; the group size must divide the heads, the width and the MLP's
one hidden layer.  LayerNorms and the adaLN modulation stay replicated.  The
fused kernels are off under either.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from ..ops.fused_mlp import fused_dit_mlp, fused_mlp_capacity_ok, fused_mlp_ok, mlp_config_fusable
from ..ops.masked import gather_segment_rows, segment_table
from .attention import MultiheadAttention
from .dense import Dense, LayerNorm, Linear, cast, xavier_uniform_


def modulate(x, shift, scale):
    """x: (B, L, F); shift/scale: (B, F), or (B, L, F) per cell."""
    if shift.ndim < x.ndim:
        shift = shift[:, None, :]
        scale = scale[:, None, :]
    return x * (1 + scale) + shift


def _gate(g, x):
    """Broadcast a (B, F) or per-cell (B, L, F) residual gate onto x."""
    return (g if g.ndim == x.ndim else g[:, None, :]) * x


def scatter_segments(seg_onehot, per_segment, segment_ids):
    """(B, E, F) per-segment rows -> (B, S, F) per-cell rows, in the promoted
    dtype of the (B, S, E) one-hot and the rows, as the JAX package's einsum
    ``bse,bef->bsf``; computed as a gather by ``segment_ids`` (bit for bit the
    einsum for finite rows; padding cells get zeros)."""
    dt = torch.promote_types(seg_onehot.dtype, per_segment.dtype)
    return gather_segment_rows(segment_table(per_segment.to(dt)), segment_ids)


def adaln_modulation(context_size: int, out_features: int, dtype=None) -> nn.Sequential:
    """Sequential(SiLU, Linear): the Linear sits in slot 1, as in the
    reference checkpoint layout."""
    return nn.Sequential(nn.SiLU(), xavier_uniform_(Linear(context_size, out_features, dtype=dtype)))


class DiTLayer(nn.Module):
    def __init__(
        self,
        embed_dim: int,
        num_heads: int,
        context_size: int,
        dense_config: Optional[dict] = None,
        attn_impl: str = "auto",
        fused_prologue: bool = False,
        dtype=None,
        sp_group=None,
        sp_mode: str = "gather",
        tp_group=None,
    ):
        super().__init__()
        self.embed_dim = embed_dim
        tp = dist.get_world_size(tp_group) if tp_group is not None else 1
        if tp > 1 and (num_heads % tp or embed_dim % tp):
            raise ValueError(f"tp_size {tp} must divide num_heads {num_heads} and embed_dim {embed_dim}")
        tp_group = tp_group if tp > 1 else None
        # fuse norm1 + adaLN modulate + QKV projection (ops/fused_qkv.py) and
        # the whole MLP half-layer (ops/fused_mlp.py) into one kernel each;
        # not under sequence or tensor parallelism
        self.fused_prologue = fused_prologue and tp == 1 and sp_group is None
        self.adaLN_modulation = adaln_modulation(context_size, 6 * embed_dim, dtype=dtype)
        self.norm1 = LayerNorm(embed_dim, dtype=dtype)
        self.mha = MultiheadAttention(embed_dim // tp, num_heads // tp, q_dim=embed_dim if tp > 1 else None,
                                      impl=attn_impl, dtype=dtype, sp_group=sp_group, sp_mode=sp_mode,
                                      tp_group=tp_group)
        self.mlp_cfg = dict(dense_config, output_size=embed_dim) if dense_config is not None else None
        if self.mlp_cfg is not None:
            if tp > 1:
                hl = list(self.mlp_cfg.get("hidden_layers") or ())
                if len(hl) != 1 or hl[0] % tp:
                    raise ValueError(f"tp_size {tp} needs one tp-divisible MLP hidden layer, got {hl}")
                self.mlp_cfg["hidden_layers"] = (hl[0] // tp,)
            self.norm2 = LayerNorm(embed_dim, dtype=dtype)
            self.dense = Dense.from_config(self.mlp_cfg, input_size=embed_dim, dtype=dtype, tp_group=tp_group)

    def forward(self, q, q_valid=None, k=None, kv_valid=None, context=None, context_seg=None, seg_onehot=None,
                attn_valid=None, attn_bias=None, segment_ids=None):
        # packed rows (context_seg (B, E, C), seg_onehot (B, S, E), segment_ids
        # (B, S)): the context is constant within a segment, so the modulation
        # net runs per segment
        mod = self.adaLN_modulation(context_seg if context_seg is not None else context)
        # packed rows fuse too: attention takes the packed kernel, and the
        # fused kernels take per-segment tables and gather each cell's row
        fuse = (self.fused_prologue and k is None and attn_valid is None and attn_bias is None
                and (segment_ids is None) == (context_seg is None))
        seg_table = fuse and context_seg is not None
        if seg_table:
            # (B, E + 1, 6F) in the einsum's promoted dtype; row E (zeros) is
            # the padding cells'.  The folds below run per segment: the same
            # elementwise arithmetic on the same values as per cell.
            mod = segment_table(mod.to(torch.promote_types(seg_onehot.dtype, mod.dtype)))
        elif context_seg is not None:
            mod = scatter_segments(seg_onehot, mod, segment_ids)
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = mod.chunk(6, dim=-1)

        if fuse:
            # fold norm1's gamma/beta with the adaLN shift/scale, in fp32, into
            # the two affine rows the fused kernel consumes
            one_scale = 1.0 + scale_msa.float()
            eff_a = self.norm1.weight.float() * one_scale
            eff_b = self.norm1.bias.float() * one_scale + shift_msa.float()
            q_attn = self.mha(q, q_valid=q_valid, fused_ln=(eff_a, eff_b), segment_ids=segment_ids)
        elif k is None:  # self-attention: modulate the tokens themselves
            q_attn = self.mha(
                modulate(self.norm1(q), shift_msa, scale_msa),
                q_valid=q_valid, attn_valid=attn_valid, attn_bias=attn_bias, segment_ids=segment_ids,
            )
        else:  # cross-attention: the modulation is applied to the keys
            q_attn = self.mha(
                q, k=modulate(self.norm1(k), shift_msa, scale_msa), q_valid=q_valid, kv_valid=kv_valid,
                attn_valid=attn_valid, attn_bias=attn_bias,
            )

        if fuse and self.mlp_cfg is not None:
            Fh = (self.mlp_cfg.get("hidden_layers") or [0])[0]
            dt = self.dense.linears[0].dtype
            if (mlp_config_fusable(self.mlp_cfg) and fused_mlp_ok(q.shape[1], self.embed_dim, Fh)
                    and fused_mlp_capacity_ok(self.embed_dim, Fh, dt)):
                # both residuals, norm2 + modulate, the MLP's own LN and the
                # two MLP products as ONE kernel (ops/fused_mlp.py)
                lin0, lin1 = self.dense.linears
                one_mlp = 1.0 + scale_mlp.float()
                eff2_a = self.norm2.weight.float() * one_mlp
                eff2_b = self.norm2.bias.float() * one_mlp + shift_mlp.float()
                return fused_dit_mlp(
                    q.to(dt), q_attn.to(dt), gate_msa.float(), eff2_a, eff2_b, gate_mlp.float(),
                    cast(lin0.weight, dt).t(), lin0.bias, cast(lin1.weight, dt).t(), lin1.bias,
                    segment_ids=segment_ids if seg_table else None,
                )

        if seg_table:  # the unfused MLP half takes per-cell rows
            gate_msa, shift_mlp, scale_mlp, gate_mlp = (
                gather_segment_rows(r, segment_ids) for r in (gate_msa, shift_mlp, scale_mlp, gate_mlp))
        q = q + _gate(gate_msa, q_attn)
        if self.mlp_cfg is not None:
            q_mlp = self.dense(modulate(self.norm2(q), shift_mlp, scale_mlp), context=context)
            q = q + _gate(gate_mlp, q_mlp)
        return q


class DiTEncoder(nn.Module):
    def __init__(
        self,
        embed_dim: int,
        num_layers: int,
        num_heads: int,
        context_size: int,
        dense_config: Optional[dict] = None,
        out_dim: int = 0,
        attn_impl: str = "auto",
        fused_prologue: bool = False,
        dtype=None,
        remat: bool = False,
        sp_group=None,
        sp_mode: str = "gather",
        tp_group=None,
    ):
        super().__init__()
        self.layers = nn.ModuleList(
            DiTLayer(embed_dim, num_heads, context_size, dense_config, attn_impl, fused_prologue, dtype,
                     sp_group=sp_group, sp_mode=sp_mode, tp_group=tp_group)
            for _ in range(num_layers)
        )
        self.final_norm = LayerNorm(embed_dim, dtype=dtype)
        self.final_linear = xavier_uniform_(Linear(embed_dim, out_dim, dtype=dtype)) if out_dim else None
        # rematerialise each layer in the backward pass: trades compute for
        # device memory, the lever for long cell sets in training
        self.remat = remat

    def forward(self, q, **kwargs):
        for layer in self.layers:
            if self.remat and torch.is_grad_enabled():
                q = checkpoint(layer, q, use_reentrant=False, **kwargs)
            else:
                q = layer(q, **kwargs)
        q = self.final_norm(q)
        if self.final_linear is not None:
            q = self.final_linear(q)
        return q
