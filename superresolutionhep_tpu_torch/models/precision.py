"""Inference-time parameter precision management.

The serving configuration computes in bf16: every module's weights are cast
once, outside the sampler loop.  The geometry embedder (``etaphi_emb_net``)
is excluded: it computes at full fp32 (bf16 inputs quantize normalized eta
below the HR subcell half-pitch), and since a module computes in the dtype of
its weights, a bf16 weight there would silently change its compute type.
"""

from __future__ import annotations

import torch
import torch.nn as nn

# module names whose params must stay fp32 (full-precision geometry path)
FP32_MODULES = ("etaphi_emb_net",)


def cast_params_for_inference(params, dtype=torch.bfloat16, keep_fp32=FP32_MODULES):
    """Cast float params to ``dtype`` except those under ``keep_fp32`` names.

    ``params`` is an ``nn.Module`` (cast in place, returned) or a
    ``state_dict``-style mapping of dotted names to tensors (a new dict is
    returned).  Non-float tensors pass through.
    """

    def keep(name: str) -> bool:
        return any(k in name.split(".") for k in keep_fp32)

    if isinstance(params, nn.Module):
        for name, p in params.named_parameters():
            if p.is_floating_point() and not keep(name):
                p.data = p.data.to(dtype)
        return params
    return {
        k: (v.to(dtype) if torch.is_tensor(v) and v.is_floating_point() and not keep(k) else v)
        for k, v in params.items()
    }
