"""Parameter and activation summaries (the non-finite-loss diagnostics).

Counterpart of the JAX package's ``models/summary.py``: min/max/mean/std
over the concatenated Linear weights and biases of each top-level submodule
(the reference's init-sanity diagnostic), and per-module statistics of the
activations of one forward, captured with forward hooks (where the JAX
package uses ``capture_intermediates``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn as nn


def _stats(vec):
    return {
        "min": float(vec.min()),
        "max": float(vec.max()),
        "mean": float(vec.mean()),
        "std": float(vec.std()),
    }


def param_summary(state_dict: Dict[str, torch.Tensor]) -> dict:
    """Per-top-level-module weight/bias statistics.  Weights are the 2-D
    ``*.weight`` tensors (Linear layers); LayerNorm scales and the embedding
    table aside, as the JAX package counts only ``kernel`` and ``bias``."""
    groups: Dict[str, dict] = {}
    for name, t in state_dict.items():
        top, leaf = name.split(".")[0], name.rsplit(".", 1)[-1]
        arr = t.detach().float().cpu().numpy().ravel()
        g = groups.setdefault(top, {"weight": [], "bias": []})
        if leaf == "weight" and t.ndim == 2 and not name.startswith("layer_emb_table"):
            g["weight"].append(arr)
        elif leaf == "bias" and t.ndim == 1 and f"{name[:-5]}.weight" in state_dict \
                and state_dict[f"{name[:-5]}.weight"].ndim == 2:
            g["bias"].append(arr)
    out = {}
    for top, g in groups.items():
        if not g["weight"]:
            continue
        entry = {"weight": _stats(np.concatenate(g["weight"]))}
        if g["bias"]:
            entry["bias"] = _stats(np.concatenate(g["bias"]))
        out[top] = entry
    return out


def activation_summary(model: nn.Module, run) -> dict:
    """Run ``run()`` (one forward of ``model``) with a forward hook on every
    submodule and return min/max/mean/std and a non-finite count of each
    tensor output, keyed by the module path."""
    out: Dict[str, dict] = {}

    def hook(name):
        def fn(_module, _inputs, output):
            tensors = output if isinstance(output, (tuple, list)) else (output,)
            for i, t in enumerate(tensors):
                if not torch.is_tensor(t) or not t.is_floating_point() or t.numel() == 0:
                    continue
                a = t.detach().float().cpu().numpy().ravel()
                finite = np.isfinite(a)
                entry = {"n_nonfinite": int((~finite).sum()), "shape": list(t.shape)}
                if finite.any():
                    entry.update(_stats(a[finite]))
                out[f"{name}[{i}]" if len(tensors) > 1 else name] = entry
        return fn

    handles = [m.register_forward_hook(hook(name or "model")) for name, m in model.named_modules()]
    try:
        with torch.no_grad():
            run()
    finally:
        for h in handles:
            h.remove()
    return out
