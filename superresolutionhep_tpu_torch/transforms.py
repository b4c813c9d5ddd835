"""Variable and target transformations with exact inverses.

Counterpart of the JAX package's ``transforms.py``: the same math on numpy
arrays (the host-side data pipeline) and on torch tensors (device side), as
plain frozen dataclasses.

Supported ``transformation`` modes: None, ``pow(x,m)``, ``pow(x,m)_signed``,
and (target only) ``logit_ratio``.  Supported ``scale_mode``: None,
``min_max`` (to a target range), ``standard``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch


def _xp(x):
    """Array namespace matching the input: numpy for host arrays and python
    scalars, torch for tensors (the handful of functions used below exist
    under the same names in both)."""
    return torch if isinstance(x, torch.Tensor) else np


@dataclasses.dataclass(frozen=True)
class VarTransform:
    """Pointwise transform + scaling with exact inverse.

    forward = scale(trans(x)); inverse = inv_trans(inv_scale(x)).
    All statistic fields may be arrays, enabling *per-event* parameterisation.
    """

    transformation: Optional[str] = None
    scale_mode: Optional[str] = None
    m: Optional[float] = None
    mean: Optional[object] = None
    std: Optional[object] = None
    min: Optional[object] = None
    max: Optional[object] = None
    range: Optional[Sequence[float]] = None

    # ---- construction -------------------------------------------------
    @classmethod
    def from_config(cls, cfg: dict) -> "VarTransform":
        return cls(
            transformation=cfg.get("transformation"),
            scale_mode=cfg.get("scale_mode"),
            m=cfg.get("m"),
            mean=cfg.get("mean"),
            std=cfg.get("std"),
            min=cfg.get("min"),
            max=cfg.get("max"),
            range=tuple(cfg["range"]) if cfg.get("range") is not None else None,
        )

    # ---- pointwise transform ------------------------------------------
    def trans(self, x):
        if self.transformation is None:
            return x
        if self.transformation == "pow(x,m)":
            return x**self.m
        if self.transformation == "pow(x,m)_signed":
            sign = (x >= 0) * 2 - 1
            return sign * (abs(x) ** self.m)
        raise ValueError(f"unknown transformation {self.transformation!r}")

    def inv_trans(self, x):
        if self.transformation is None:
            return x
        if self.transformation == "pow(x,m)":
            return x ** (1.0 / self.m)
        if self.transformation == "pow(x,m)_signed":
            sign = (x >= 0) * 2 - 1
            return sign * (abs(x) ** (1.0 / self.m))
        raise ValueError(f"unknown transformation {self.transformation!r}")

    # ---- scaling -------------------------------------------------------
    def scale(self, x):
        if self.scale_mode is None:
            return x
        if self.scale_mode == "min_max":
            lo, hi = self.min, self.max
            x = (x - lo) / (hi - lo)
            tmin, tmax = self.range
            return x * (tmax - tmin) + tmin
        if self.scale_mode == "standard":
            return (x - self.mean) / self.std
        raise ValueError(f"unknown scale_mode {self.scale_mode!r}")

    def inv_scale(self, x):
        if self.scale_mode is None:
            return x
        if self.scale_mode == "min_max":
            tmin, tmax = self.range
            x = (x - tmin) / (tmax - tmin)
            return x * (self.max - self.min) + self.min
        if self.scale_mode == "standard":
            return x * self.std + self.mean
        raise ValueError(f"unknown scale_mode {self.scale_mode!r}")

    # ---- public API ------------------------------------------------------
    def forward(self, x):
        return self.scale(self.trans(x))

    def inverse(self, x):
        return self.inv_trans(self.inv_scale(x))

    # ---- per-event statistics -------------------------------------------
    def fit(self, x, axis=None, keepdims=False) -> "VarTransform":
        """Return a copy parameterised by statistics of ``trans(x)`` (numpy
        input).  `std` uses ddof=1 to match ``torch.Tensor.std`` (unbiased)."""
        t = self.trans(x)
        kw = {}
        if self.scale_mode == "min_max":
            kw["min"] = t.min(axis=axis, keepdims=keepdims)
            kw["max"] = t.max(axis=axis, keepdims=keepdims)
        elif self.scale_mode == "standard":
            kw["mean"] = t.mean(axis=axis, keepdims=keepdims)
            kw["std"] = t.std(axis=axis, ddof=1, keepdims=keepdims)
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class TargetTransform(VarTransform):
    """``logit_ratio`` target transform.

    forward: ratio = clip(hr_truth / (proxy * f), 0, 1);
             ratio -> alpha + (1-2 alpha) ratio;  logit;  then standard scale.
    inverse: inv_scale -> sigmoid -> un-squeeze -> * proxy * f.
    """

    f: float = 1.2
    alpha: float = 1e-6

    @classmethod
    def from_config(cls, cfg: dict) -> "TargetTransform":
        base = VarTransform.from_config(cfg)
        return cls(
            **{fld.name: getattr(base, fld.name) for fld in dataclasses.fields(VarTransform)},
            f=cfg.get("f", 1.2),
            alpha=cfg.get("alpha", 1e-6),
        )

    def trans(self, hr_truth_raw, proxy_raw=None):  # type: ignore[override]
        if self.transformation != "logit_ratio":
            raise ValueError(f"unknown target transformation {self.transformation!r}")
        assert proxy_raw is not None, "proxy_raw must be provided"
        xp = _xp(hr_truth_raw)
        ratio = hr_truth_raw / (proxy_raw * self.f)
        ratio = xp.clip(ratio, 0.0, 1.0)
        ratio = self.alpha + (1 - 2 * self.alpha) * ratio
        return xp.log(ratio / (1 - ratio))

    def inv_trans(self, nn_out, proxy_raw=None):  # type: ignore[override]
        if self.transformation != "logit_ratio":
            raise ValueError(f"unknown target transformation {self.transformation!r}")
        assert proxy_raw is not None, "proxy_raw must be provided"
        xp = _xp(nn_out)
        ratio = 1.0 / (1.0 + xp.exp(-nn_out))
        ratio = (ratio - self.alpha) / (1 - 2 * self.alpha)
        return ratio * proxy_raw * self.f

    def forward(self, hr_truth_raw, proxy_raw=None):  # type: ignore[override]
        return self.scale(self.trans(hr_truth_raw, proxy_raw))

    def inverse(self, nn_out, proxy_raw=None):  # type: ignore[override]
        return self.inv_trans(self.inv_scale(nn_out), proxy_raw)


def build_var_transforms(var_transform_cfg: dict) -> dict[str, VarTransform]:
    """Build the per-variable transform dict from the ``var_transform`` config
    block."""
    return {k: VarTransform.from_config(v) for k, v in var_transform_cfg.items()}
