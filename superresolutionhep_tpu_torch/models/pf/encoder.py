"""PF cell encoder.

Counterpart of the JAX package's ``models/pf/encoder.py``: each cell as
[e, eta, cosphi, sinphi, layer embedding] -> Linear -> LeakyReLU -> Linear to
h_dim; a masked-mean global context; a DiT self-attention stack conditioned
on it (head dim h_dim / num_heads: 16 in the published configuration, which
the flash kernels take).

Parallelism, as in the JAX package: with ``sp_group`` the cell axis arrives
sharded over that process group, the global context is a masked mean summed
over it and the DiT stack gathers (``sp_mode='gather'``) or rotates
(``'ring'``) the keys; with ``tp_group`` the stack's heads and MLP are
sharded over it (models/dit.py).  The fused prologue is not taken under
either (models/dit.py).

``cell_init_net.0`` (the first, geometry-carrying product) has no compute
dtype: its weights stay fp32 and it is fed fp32 features, so it runs in full
fp32 under a bf16 model (the JAX package's ``precision="highest"``; TF32 must
be off, which the entry points set).  Module names are the reference
checkpoint's (tools/convert.py).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...ops.masked import masked_mean
from ..dense import Linear, cast, xavier_uniform_
from ..dit import DiTEncoder

N_CALO_LAYERS = 3


class PFEncoder(nn.Module):
    def __init__(self, config_pf: dict, attn_impl: str = "auto", fused_prologue: bool = False, dtype=None,
                 sp_group=None, sp_mode: str = "gather", tp_group=None):
        super().__init__()
        self.compute_dtype = dtype
        self.sp_group = sp_group
        h_dim = int(config_pf["h_dim"])
        enc = config_pf["encoder"]
        emb_dim = int(enc["layer_emb_dim"])
        self.layer_emb_net = nn.Embedding(N_CALO_LAYERS, emb_dim)
        self.cell_init_net = nn.Sequential(
            xavier_uniform_(Linear(4 + emb_dim, h_dim)), nn.LeakyReLU(0.01),
            xavier_uniform_(Linear(h_dim, h_dim, dtype=dtype)),
        )
        tcfg = enc["transformer"]
        self.transformer = DiTEncoder(
            embed_dim=h_dim, num_layers=int(tcfg["num_transformer_layers"]), num_heads=int(tcfg["num_heads"]),
            context_size=h_dim, dense_config=dict(tcfg["dense_config"]), attn_impl=attn_impl,
            fused_prologue=fused_prologue, dtype=dtype, sp_group=sp_group, sp_mode=sp_mode, tp_group=tp_group,
        )

    def forward(self, batch):
        cell_mask = batch["cell_mask"]
        # the table gathered in its own dtype, then cast (the Flax Embed's dtype)
        layer_emb = cast(self.layer_emb_net.weight[batch["cell_layer"].long()], self.compute_dtype)
        feat0 = torch.cat([batch["cell_e"][..., None], batch["cell_eta"][..., None], batch["cell_cosphi"][..., None],
                           batch["cell_sinphi"][..., None], layer_emb], dim=-1)
        x = self.cell_init_net[0](feat0.float())
        x = F.leaky_relu(x, 0.01).to(self.compute_dtype or feat0.dtype)
        x = self.cell_init_net[2](x)
        global_feat = masked_mean(x, cell_mask, axis=1, group=self.sp_group)
        return self.transformer(x, q_valid=cell_mask, context=global_feat)
