"""Timestep embedding (GLIDE-style sinusoidal + SiLU MLP)."""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from .dense import Linear, xavier_uniform_


def timestep_embedding(t, dim: int, max_period: float = 10_000.0):
    """Sinusoidal frequency embedding of scalar timesteps.

    t: (B,) possibly-fractional timesteps. Returns (B, dim) fp32 as
    [cos(t*f_0..), sin(t*f_0..)].
    """
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t[:, None].float() * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class TimestepEmbedder(nn.Module):
    def __init__(self, hidden_size: int, frequency_embedding_size: int = 256, dtype=None):
        super().__init__()
        self.frequency_embedding_size = frequency_embedding_size
        # Sequential(Linear, SiLU, Linear): keys mlp.0 / mlp.2 as in the reference
        self.mlp = nn.Sequential(
            xavier_uniform_(Linear(frequency_embedding_size, hidden_size, dtype=dtype)),
            nn.SiLU(),
            xavier_uniform_(Linear(hidden_size, hidden_size, dtype=dtype)),
        )

    def forward(self, t):
        return self.mlp(timestep_embedding(t, self.frequency_embedding_size))
