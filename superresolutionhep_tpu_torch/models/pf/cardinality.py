"""Cardinality head: masked mean pool -> Dense -> logits over max_particles + 1
classes (class 0 = no particle).  Counterpart of the JAX package's
``models/pf/cardinality.py``; with ``sp_group`` (cells sharded over it) the
pool sums over the group."""

from __future__ import annotations

import torch.nn as nn

from ...ops.masked import masked_mean
from ..dense import Dense


class CardinalityPredictor(nn.Module):
    def __init__(self, config_pf: dict, dtype=None, sp_group=None):
        super().__init__()
        self.sp_group = sp_group
        head_cfg = dict(config_pf["cardinality_predictor"], output_size=int(config_pf["max_particles"]) + 1)
        self.card_pred_net = Dense.from_config(head_cfg, input_size=int(config_pf["h_dim"]), dtype=dtype)

    def forward(self, encoded_feat, cell_mask):
        return self.card_pred_net(masked_mean(encoded_feat, cell_mask, axis=1, group=self.sp_group))
