"""Context-aware MLP block.

Counterpart of the JAX package's ``models/dense.py``: per-layer optional
LayerNorm (no learnable affine, eps 1e-5), dropout, activation; optional
final activation; optional broadcast-concatenated context.  Order per layer:
norm -> dropout -> linear -> activation.

The modules sit in an ``nn.Sequential`` named ``net`` so that the
``state_dict`` keys are the reference checkpoint's (``net.{i}.weight``).

Compute dtype, the Flax ``dtype=`` of the JAX package: each module takes a
``dtype``; the weights are cast to it at use, so the parameters stay in
their own dtype (fp32 in training) and receive their gradients there.  With
``dtype=None`` a module computes in the dtype of its own weights: the
serving path casts the weights once (``models/precision.py``, bf16
everywhere but the geometry embedder).  Inputs are cast to the compute
dtype on entry; LayerNorm statistics are always fp32.

Tensor parallelism (``tp_group``, Megatron's MLP split, as in the JAX
package): the single hidden layer is column-parallel (the module is built
with the LOCAL hidden width), the output layer row-parallel, its partial
products summed over the group by ``g`` before any final activation, and
the input passes Megatron's ``f`` (ops/tp.py).  It needs exactly one hidden
layer, no ``norm_final_layer`` and no active dropout.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.masked import attach_context
from ..ops.tp import tp_allreduce, tp_block_input

LN_EPS = 1e-5  # torch.nn.LayerNorm default

ACTIVATIONS = {
    "ReLU": nn.ReLU,
    "LeakyReLU": lambda: nn.LeakyReLU(0.01),
    "SiLU": nn.SiLU,
    "GELU": nn.GELU,
    "Tanh": nn.Tanh,
    "Sigmoid": nn.Sigmoid,
    "ELU": nn.ELU,
}


def layer_norm(x, weight=None, bias=None, out_dtype=None, eps: float = LN_EPS):
    """LayerNorm over the last axis with fp32 statistics (E[x^2] - E[x]^2,
    clamped at 0, as Flax computes them), optional affine, result cast to
    ``out_dtype`` (default: x's dtype)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf * xf).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
    mul = torch.rsqrt(var + eps)
    if weight is not None:
        mul = mul * weight.float()
    y = (xf - mean) * mul
    if bias is not None:
        y = y + bias.float()
    return y.to(out_dtype or x.dtype)


def cast(t, dtype):
    """``t`` in ``dtype`` (None: unchanged); differentiable."""
    return t if dtype is None or t is None else t.to(dtype)


class Linear(nn.Linear):
    """nn.Linear computing in ``dtype`` (default: the weight's dtype): input,
    weight and bias are cast to it, as Flax ``nn.Dense(dtype=...)`` does."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, dtype=None):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    @property
    def dtype(self):
        return self.compute_dtype or self.weight.dtype

    def forward(self, x):
        dt = self.dtype
        return F.linear(x.to(dt), cast(self.weight, dt), cast(self.bias, dt))


class LayerNorm(nn.Module):
    """Affine LayerNorm (eps 1e-5) with fp32 statistics; output in ``dtype``
    (default: the dtype of its parameters)."""

    def __init__(self, dim: int, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.compute_dtype = dtype

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, out_dtype=self.compute_dtype or self.weight.dtype)


class _NormNoAffine(nn.Module):
    """Parameter-free pre-linear LayerNorm; ``Dense`` passes the dtype."""

    def forward(self, x, out_dtype=None):
        return layer_norm(x, out_dtype=out_dtype)


def xavier_uniform_(linear: nn.Linear):
    nn.init.xavier_uniform_(linear.weight)
    if linear.bias is not None:
        nn.init.zeros_(linear.bias)
    return linear


class Dense(nn.Module):
    """MLP with optional per-layer norm/dropout/activation and context concat."""

    def __init__(
        self,
        input_size: int,
        output_size: int,
        hidden_layers: Sequence[int] = (),
        activation: str = "ReLU",
        final_activation: Optional[str] = None,
        norm_layer: Optional[str] = None,
        norm_final_layer: bool = False,
        dropout: float = 0.0,
        context_size: int = 0,
        dtype=None,
        tp_group=None,
    ):
        super().__init__()
        if norm_layer not in (None, "LayerNorm"):
            raise ValueError(f"unsupported norm layer {norm_layer!r}")
        if tp_group is not None:
            if len(hidden_layers) != 1:
                raise ValueError("tp_group requires exactly one hidden layer")
            if norm_final_layer:
                raise ValueError("tp_group: norm_final_layer would normalize the sharded hidden")
        self.tp_group = tp_group
        self.context_size = int(context_size)
        sizes = [*hidden_layers, output_size]
        mods = []
        n_in = input_size + self.context_size
        for i, size in enumerate(sizes):
            is_final = i == len(sizes) - 1
            if norm_layer and (norm_final_layer or not is_final):
                mods.append(_NormNoAffine())
            if dropout and (norm_final_layer or not is_final):
                mods.append(nn.Dropout(dropout))
            mods.append(xavier_uniform_(Linear(n_in, size, dtype=dtype)))
            if not is_final:
                mods.append(ACTIVATIONS[activation]())
            elif final_activation:
                mods.append(ACTIVATIONS[final_activation]())
            n_in = size
        self.net = nn.Sequential(*mods)

    @classmethod
    def from_config(cls, cfg: dict, input_size: int, dtype=None, tp_group=None) -> "Dense":
        """Build from a reference-style dense config dict.  The config's own
        ``input_size`` is ignored (the caller knows the real width; the
        configs carry placeholders such as -1)."""
        return cls(
            input_size=input_size,
            output_size=cfg["output_size"],
            hidden_layers=tuple(cfg.get("hidden_layers", ()) or ()),
            activation=cfg.get("activation") or "ReLU",
            final_activation=cfg.get("final_activation"),
            norm_layer=cfg.get("norm_layer"),
            norm_final_layer=bool(cfg.get("norm_final_layer", False)),
            dropout=float(cfg.get("dropout", 0.0) or 0.0),
            context_size=int(cfg.get("context_size", 0) or 0),
            dtype=dtype,
            tp_group=tp_group,
        )

    @property
    def linears(self):
        return [m for m in self.net if isinstance(m, nn.Linear)]

    def forward(self, x, context=None):
        if self.context_size:
            x = attach_context(x, context)
        dtype = self.linears[0].dtype
        last = self.linears[-1]
        if self.tp_group is not None:
            if self.training and any(isinstance(m, nn.Dropout) and m.p > 0 for m in self.net):
                raise ValueError("tp_group: active dropout would desync shards")
            x = tp_block_input(x, self.tp_group)
        for m in self.net:
            x = m(x, out_dtype=dtype) if isinstance(m, _NormNoAffine) else m(x)
            if m is last:  # row-parallel output: sum the partial products first
                x = tp_allreduce(x, self.tp_group)
        return x
