"""GPT-2 + Normformer encoder stack.

Counterpart of the JAX package's ``models/transformer.py``: the pre-norm
layer ``x + norm2(mha(norm1(x)))`` followed by ``x + dense(x, context)``; the
stack with a final LayerNorm and an optional resize; the cross-attention
layer.  Edge features and edge updates are threaded through the shared
``MultiheadAttention`` (its general path); without them its hot path takes
the flash kernels on the card, as in the DiT stack.
"""

from __future__ import annotations

from typing import Optional

import torch.nn as nn

from .attention import MultiheadAttention
from .dense import Dense, LayerNorm, Linear


def _dense(dense_config, embed_dim, dtype):
    if dense_config is None:
        return None
    cfg = dict(dense_config, output_size=embed_dim)
    return Dense.from_config(cfg, input_size=embed_dim, dtype=dtype)


class TransformerEncoderLayer(nn.Module):
    def __init__(
        self,
        embed_dim: int,
        num_heads: int,
        dense_config: Optional[dict] = None,
        edge_embed_dim: int = 0,
        update_edges: bool = False,
        attn_impl: str = "auto",
        dtype=None,
    ):
        super().__init__()
        self.mha = MultiheadAttention(embed_dim, num_heads, impl=attn_impl, dtype=dtype,
                                      edge_embed_dim=edge_embed_dim, update_edges=update_edges)
        self.norm1 = LayerNorm(embed_dim, dtype=dtype)
        self.norm2 = LayerNorm(embed_dim, dtype=dtype)
        self.update_edges = bool(update_edges)
        if edge_embed_dim:
            self.enorm1 = LayerNorm(edge_embed_dim, dtype=dtype)
            if update_edges:
                self.enorm2 = LayerNorm(edge_embed_dim, dtype=dtype)
        self.dense = _dense(dense_config, embed_dim, dtype)

    def forward(self, x, edge_x=None, valid=None, context=None, attn_valid=None, attn_bias=None,
                dropout_generator=None):
        """x: (B, L, F); edge_x: (B, L, L, E) or None.  Returns x, or
        (x, edge_x) when edges are given."""
        kw = dict(q_valid=valid, attn_valid=attn_valid, attn_bias=attn_bias, dropout_generator=dropout_generator)
        if edge_x is not None:
            xi, edge_xi = self.mha(self.norm1(x), edges=self.enorm1(edge_x), **kw)
        else:
            xi = self.mha(self.norm1(x), **kw)
        x = x + self.norm2(xi)
        if self.update_edges and edge_x is not None:
            edge_x = edge_x + self.enorm2(edge_xi)
        if self.dense is not None:
            x = x + self.dense(x, context=context)
        if edge_x is not None:
            return x, edge_x
        return x


class TransformerEncoder(nn.Module):
    def __init__(
        self,
        embed_dim: int,
        num_layers: int,
        num_heads: int,
        dense_config: Optional[dict] = None,
        out_dim: int = 0,
        edge_embed_dim: int = 0,
        update_edges: bool = False,
        attn_impl: str = "auto",
        dtype=None,
    ):
        super().__init__()
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(
                embed_dim, num_heads, dense_config, edge_embed_dim,
                # the last layer never updates edges (the reference's rule)
                update_edges=update_edges if i != num_layers - 1 else False,
                attn_impl=attn_impl, dtype=dtype,
            )
            for i in range(num_layers)
        )
        self.final_norm = LayerNorm(embed_dim, dtype=dtype)
        self.final_linear = Linear(embed_dim, out_dim, dtype=dtype) if out_dim else None

    def forward(self, x, edge_x=None, **kwargs):
        """Returns the node features only, edges or not."""
        for layer in self.layers:
            if edge_x is not None:
                x, edge_x = layer(x, edge_x, **kwargs)
            else:
                x = layer(x, **kwargs)
        x = self.final_norm(x)
        if self.final_linear is not None:
            x = self.final_linear(x)
        return x


class TransformerCrossAttentionLayer(nn.Module):
    """query + norm2(mha(norm1(query), norm0(key_value))), then the FFN."""

    def __init__(self, embed_dim: int, num_heads: int, dense_config: Optional[dict] = None,
                 attn_impl: str = "auto", dtype=None):
        super().__init__()
        self.mha = MultiheadAttention(embed_dim, num_heads, impl=attn_impl, dtype=dtype)
        self.norm0 = LayerNorm(embed_dim, dtype=dtype)
        self.norm1 = LayerNorm(embed_dim, dtype=dtype)
        self.norm2 = LayerNorm(embed_dim, dtype=dtype)
        self.dense = _dense(dense_config, embed_dim, dtype)

    def forward(self, query, key_value, query_valid=None, key_value_valid=None, context=None):
        xi = self.mha(self.norm1(query), self.norm0(key_value), q_valid=query_valid, kv_valid=key_value_valid)
        query = query + self.norm2(xi)
        if self.dense is not None:
            query = query + self.dense(query, context=context)
        return query
