"""Lightning-shaped checkpoint files in the reference's layout.

The port's counterparts of the JAX package's
``tools/torch_convert.py::load_lightning_checkpoint`` and
``tools/torch_export.py::save_lightning_checkpoint``: a ``.ckpt`` is a
``torch.save``d dict whose ``state_dict`` holds the model's tensors under the
reference's ``net.``-prefixed keys (the layout ``FlowModel`` and ``SAPF``
load with ``load_reference_state_dict(strict=True)``), beside
``hyper_parameters``, ``epoch``, ``global_step`` and the Lightning version
string the reference's load paths expect.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

LIGHTNING_VERSION = "2.0.0"


def load_lightning_checkpoint(path: str):
    """(state_dict, hyper_parameters) of a Lightning ``.ckpt``, tensors on the
    CPU.  A checkpoint written by Lightning itself pickles its
    hyper-parameters as Lightning objects, so the file is unpickled in full
    (as the JAX package's reader does), which runs code it holds: load only
    checkpoints from a trusted source."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return ckpt["state_dict"], ckpt.get("hyper_parameters", {})


def save_lightning_checkpoint(state_dict: Dict[str, object], path: str, hyper_parameters: Optional[dict] = None,
                              epoch: int = 0, global_step: int = 0) -> str:
    """Write ``state_dict`` (numpy arrays or tensors, any device) as the
    minimal Lightning checkpoint dict the JAX package's writer writes; keys
    without the reference's ``net.`` prefix (a port model's own
    ``state_dict()``) get it.  Returns ``path``."""
    sd = {}
    for k, v in state_dict.items():
        t = v.detach().cpu() if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
        sd[k if k.startswith("net.") else f"net.{k}"] = t.contiguous()
    torch.save({"state_dict": sd, "hyper_parameters": hyper_parameters or {}, "epoch": epoch,
                "global_step": global_step, "pytorch-lightning_version": LIGHTNING_VERSION}, path)
    return path
