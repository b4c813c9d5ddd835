"""SAPF, the set-attention particle-flow model (stage 2).

Counterpart of the JAX package's ``models/pf/model_pf.py``: the cell encoder,
the cardinality head and the kinematics head.  With ``inference=True`` the
predicted cardinality gates the particle query mask
(``arange(max_particles) < argmax(logits)``); in training the batch's
``part_mask`` does.

``dtype`` is the compute dtype (bf16 for mixed precision; parameters stay
fp32), and ``fused_prologue`` asks the encoder's DiT layers for the fused kernels, which
at the published width (h_dim 64, not a multiple of 128) take their unfused
equivalent, as in the JAX package.  Parameter names are the reference
checkpoint's: ``load_reference_state_dict`` takes the ``net.*`` layout of
``tools/convert.py::pf_params_from_jax``.

``sp_group``/``sp_mode`` (cells sharded over a sequence-parallel group) and
``tp_group`` (both DiT stacks' heads and MLPs sharded over a tensor-parallel
group) go to the parts, as in the JAX package (parallel/sp.py,
parallel/tp.py build them).
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
import torch.nn as nn

from .cardinality import CardinalityPredictor
from .encoder import PFEncoder
from .kinematics import KinematicsPredictor


class SAPF(nn.Module):
    def __init__(self, config_pf: dict, transforms: Optional[Mapping] = None, inference: bool = False,
                 attn_impl: str = "auto", fused_prologue: bool = False, dtype=None, sp_group=None,
                 sp_mode: str = "gather", tp_group=None):
        super().__init__()
        self.config_pf = config_pf
        self.inference = inference
        self.max_part = int(config_pf["max_particles"])
        groups = dict(sp_group=sp_group, sp_mode=sp_mode, tp_group=tp_group)
        self.encoder = PFEncoder(config_pf, attn_impl=attn_impl, fused_prologue=fused_prologue, dtype=dtype, **groups)
        self.cardinality_predictor = (CardinalityPredictor(config_pf, dtype=dtype, sp_group=sp_group)
                                      if config_pf.get("cardinality_predictor") is not None else None)
        self.kinematics_predictor = (
            KinematicsPredictor(config_pf, transforms=transforms, attn_impl=attn_impl, dtype=dtype, **groups)
            if config_pf.get("kinematics_predictor") is not None else None)

    def load_reference_state_dict(self, state_dict, strict: bool = True):
        """Load a reference-layout ``state_dict`` (keys ``net.*`` or already
        stripped); tensors are cast to each parameter's current dtype."""
        sd = {(k[4:] if k.startswith("net.") else k): v for k, v in state_dict.items()}
        return self.load_state_dict(sd, strict=strict)

    def forward(self, batch, noise=None, generator=None):
        """batch: collate_pf's keys as tensors.  ``noise`` (B, P, h_dim): the
        random slots' draws (``init_particles.type: random`` only; default
        from ``generator``).  Returns (logits (B, P+1) or None, kin (B, P, 4)
        or None, inc_weights (B, P, N) or None)."""
        encoded = self.encoder(batch)
        logits = None
        if self.cardinality_predictor is not None:
            logits = self.cardinality_predictor(encoded, batch["cell_mask"])
        kin = inc = None
        if self.kinematics_predictor is not None:
            if self.inference:
                n_pred = torch.argmax(logits, dim=-1)
                part_mask = torch.arange(self.max_part, device=encoded.device)[None, :] < n_pred[:, None]
            else:
                part_mask = batch["part_mask"]
            kin, inc = self.kinematics_predictor(encoded, batch["cell_mask"], part_mask, batch, noise=noise,
                                                 generator=generator)
        return logits, kin, inc
