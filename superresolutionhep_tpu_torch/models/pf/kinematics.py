"""Kinematics predictor: particle query slots, DiT cross-attention over the
cells, and the attention-based kinematic head.

Counterpart of the JAX package's ``models/pf/kinematics.py``:
  * slots from an Embedding + projection (``init_particles.type:
    embedding``, the published configuration), or random gaussian slots
    ``mu + exp(logsigma) * noise`` (``type: random``) whose noise is an input
    (or drawn from a ``torch.Generator``);
  * DiT cross-attention, particle queries over cell keys, conditioned on the
    masked-mean cell context (the modulation applied to the keys); with 4
    queries it takes the dense attention formulation, as in the JAX package;
  * ``AttnKinematicNet``: single-head q.k scores with the softmax over the
    PARTICLE axis (each cell's energy splits across particles), per-particle
    E/eta/phi as incidence-weighted sums, pt = E / cosh(eta) (zero mass), then
    the forward transforms into target space.

Parallelism, as in the JAX package: with ``sp_group`` the cells are sharded
over that group and the particles replicated on every shard; the cell context
is a masked mean summed over the group, the cross-attention gathers (or
rotates, ``sp_mode='ring'``) the cell keys and values while the particle
queries stay whole, and the kinematic head's sums over cells are summed over
the group (its softmax runs over the particle axis, local to each cell).
``tp_group`` shards the cross-attention stack's heads and MLP.
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import torch
import torch.nn as nn

from ...ops.masked import masked_mean, masked_softmax, merge_masks
from ...parallel.comm import psum
from ..dense import Dense, Linear, cast, xavier_uniform_
from ..dit import DiTEncoder


class AttnKinematicNet(nn.Module):
    def __init__(self, h_dim: int, transforms: Optional[Mapping] = None, dtype=None, sp_group=None):
        super().__init__()
        self.h_dim = h_dim
        self.sp_group = sp_group
        self.transforms = transforms
        self.linear_q = xavier_uniform_(Linear(h_dim, h_dim, dtype=dtype))
        self.linear_k = xavier_uniform_(Linear(h_dim, h_dim, dtype=dtype))

    def forward(self, q, k, part_valid, cell_valid, batch):
        """q: (B, P, H) particle features; k: (B, N, H) cell features.
        Returns (kin_pred (B, P, 4), inc_weights (B, P, N))."""
        mask = merge_masks(part_valid, cell_valid, None, q.shape[1], k.shape[1])
        scores = torch.einsum("bph,bnh->bpn", self.linear_q(q), self.linear_k(k)) / math.sqrt(self.h_dim)
        inc_weights = masked_softmax(scores, mask, axis=1)  # over the particles

        e_raw_inc = inc_weights * batch["cell_e_raw"][:, None, :]  # (B, P, N)
        row_sum = self.cell_sum(e_raw_inc, keepdim=True)
        inc = e_raw_inc / (row_sum + (row_sum == 0).to(row_sum.dtype))  # per-particle cell shares
        eta_pred_raw = self.cell_sum(inc * batch["cell_eta_raw"][:, None, :])
        phi_pred = self.cell_sum(inc * batch["cell_phi"][:, None, :])
        e_pred_raw = self.cell_sum(e_raw_inc)
        pt_pred_raw = e_pred_raw / torch.cosh(eta_pred_raw)  # zero mass
        tr = self.transforms
        kin_pred = torch.stack(
            [tr["pt"].forward(pt_pred_raw), tr["eta"].forward(eta_pred_raw), phi_pred, tr["e"].forward(e_pred_raw)],
            dim=-1)
        return kin_pred, inc_weights

    def cell_sum(self, x, keepdim: bool = False):
        """Sum over the cell axis, over every shard of the sequence group."""
        return psum(x.sum(-1, keepdim=keepdim), self.sp_group)


class KinematicsPredictor(nn.Module):
    def __init__(self, config_pf: dict, transforms: Optional[Mapping] = None, attn_impl: str = "auto", dtype=None,
                 sp_group=None, sp_mode: str = "gather", tp_group=None):
        super().__init__()
        self.compute_dtype = dtype
        self.sp_group = sp_group
        kcfg = config_pf["kinematics_predictor"]
        h_dim = int(config_pf["h_dim"])
        self.h_dim, self.max_part = h_dim, int(config_pf["max_particles"])
        init_cfg = kcfg["init_particles"]
        self.init_type = init_cfg["type"]
        if self.init_type == "embedding":
            self.particle_emb_net = nn.Embedding(self.max_part, int(init_cfg["embedding_dim"]))
            self.particle_proj = xavier_uniform_(Linear(int(init_cfg["embedding_dim"]), h_dim, dtype=dtype))
        elif self.init_type == "random":
            bound = math.sqrt(6.0 / (1 + h_dim))  # Flax xavier_uniform of a (1, 1, h) leaf
            self.edges_mu = nn.Parameter(torch.randn(1, 1, h_dim))
            self.edges_logsigma = nn.Parameter(torch.empty(1, 1, h_dim).uniform_(-bound, bound))
        else:
            raise ValueError(f"unknown init_particles type {self.init_type!r}")
        tcfg = kcfg["transformer"]
        self.transformer = DiTEncoder(
            embed_dim=h_dim, num_layers=int(tcfg["num_transformer_layers"]), num_heads=int(tcfg["num_heads"]),
            context_size=h_dim, dense_config=dict(tcfg["dense_config"]), attn_impl=attn_impl, dtype=dtype,
            sp_group=sp_group, sp_mode=sp_mode, tp_group=tp_group,
        )
        self.use_attn_kinematics = bool(kcfg.get("use_attn_kinematics", False))
        if self.use_attn_kinematics:
            self.kin_net = AttnKinematicNet(h_dim, transforms=transforms, dtype=dtype, sp_group=sp_group)
        else:
            self.kin_net = Dense.from_config(kcfg["pt_eta_phi_e_net"], input_size=h_dim, dtype=dtype)

    def slots(self, B: int, device, noise=None, generator=None):
        """(B, max_particles, h_dim) particle query slots."""
        if self.init_type == "embedding":
            table = cast(self.particle_emb_net.weight, self.compute_dtype)  # rows 0 .. P-1, as the Flax Embed
            return self.particle_proj(table[None].expand(B, *table.shape))
        shape = (B, self.max_part, self.h_dim)
        if noise is None:
            noise = torch.randn(shape, generator=generator, device=device)
        noise = torch.as_tensor(noise, dtype=self.edges_mu.dtype, device=device)
        return self.edges_mu + torch.exp(self.edges_logsigma) * noise

    def forward(self, cell_feat, cell_mask, part_mask, batch, noise=None, generator=None):
        particle_emb = self.slots(cell_feat.shape[0], cell_feat.device, noise, generator)
        cell_global = masked_mean(cell_feat, cell_mask, axis=1, group=self.sp_group)
        part_feat = self.transformer(particle_emb, q_valid=part_mask, k=cell_feat, kv_valid=cell_mask,
                                     context=cell_global)
        if self.use_attn_kinematics:
            return self.kin_net(part_feat, cell_feat, part_mask, cell_mask, batch)
        return self.kin_net(part_feat), None
