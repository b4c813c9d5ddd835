"""Config system: two-file YAML split mirroring the reference CLI surface.

The reference drives everything from a pair of YAML files
(``model_and_var.yml`` + ``train.yml``) passed as ``-cmv``/``-ct``, plus a third
inference YAML (``-i``) that points at a saved pair and a checkpoint
(reference: train.py:30-53, inference.py:39-49, configs/single_e/*).

We keep the exact same file formats so configs written for the reference load
unchanged, but unlike the reference we never mutate config dicts in place while
building models (reference quirk: models/flow_model.py:44-110 patches sizes
into the config) — resolution happens into a separate resolved view.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Mapping

def load_yaml(path: str | os.PathLike) -> dict:
    import yaml  # host-side only; the device entry points take loaded mappings

    with open(path, "r") as fp:
        return yaml.safe_load(fp)


def load_config_pair(config_mv_path: str, config_t_path: str) -> tuple[dict, dict]:
    """Load the (model_and_var, train) YAML pair."""
    return load_yaml(config_mv_path), load_yaml(config_t_path)


def deep_update(base: dict, patch: Mapping[str, Any]) -> dict:
    """Recursively merge ``patch`` into a deep copy of ``base``."""
    out = copy.deepcopy(base)
    for k, v in patch.items():
        if isinstance(v, Mapping) and isinstance(out.get(k), dict):
            out[k] = deep_update(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def resolve_threshold(value) -> int | None:
    """Resolve an ``n_sq_sum_threshold`` config entry.

    The reference ``eval()``'s arbitrary strings like ``"3520**2 * 6"``
    (utility/sampler.py:18).  We accept ints directly and parse the restricted
    arithmetic grammar (digits, ** * + - // / parentheses and spaces) without
    eval of arbitrary code.
    """
    if value is None:
        return None
    if isinstance(value, (int, float)):
        return int(value)
    s = str(value)
    allowed = set("0123456789*+-/() .")
    if not set(s) <= allowed:
        raise ValueError(f"unsafe threshold expression: {s!r}")
    return int(eval(s, {"__builtins__": {}}, {}))  # noqa: S307 - charset-restricted arithmetic


def frozen(cfg: Mapping) -> "FrozenConfig":
    return FrozenConfig(cfg)


class FrozenConfig(Mapping):
    """Read-only mapping view over a config dict (guards against the in-place
    mutation pattern of the reference)."""

    def __init__(self, data: Mapping):
        self._data = dict(data)

    def __getitem__(self, k):
        v = self._data[k]
        return FrozenConfig(v) if isinstance(v, dict) else v

    def get(self, k, default=None):
        try:
            return self[k]
        except KeyError:
            return default

    def __iter__(self):
        return iter(self._data)

    def __len__(self):
        return len(self._data)

    def __repr__(self):
        return f"FrozenConfig({self._data!r})"

    def to_dict(self) -> dict:
        return copy.deepcopy(self._data)
