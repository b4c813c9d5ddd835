"""Checkpointing with the reference's retention policy, on ``torch.save``.

Counterpart of the JAX package's ``train/checkpoint.py`` (an Orbax manager
there): keep the best 3 checkpoints by a monitored metric (min mode) plus
always the last; write both configs beside the weights (``configs.json``)
and the metric history with the best step (``best_meta.json``); restore the
last or the best.

Layout under ``directory``: ``best/<step>.pt``, ``last/<step>.pt``,
``best_meta.json``, ``configs.json``.  Each ``.pt`` holds the saved state (a
dict of tensors and nested dicts) and the metrics it was saved with; it is
written to a temporary name and renamed, so a crash never leaves half a
checkpoint under a step's name.
"""

from __future__ import annotations

import json
import os
from typing import Any, Optional

import torch

from .msgpack_io import read_msgpack


def _steps(d: str):
    return sorted(int(f[:-3]) for f in os.listdir(d) if f.endswith(".pt") and f[:-3].isdigit())


def _atomic_save(obj, path: str):
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    def __init__(
        self,
        directory: str,
        monitor: str = "val/loss_raw",
        max_to_keep: int = 3,
        configs: Optional[dict] = None,
    ):
        """Lower ``monitor`` is better; a save without it ranks last."""
        self.directory = os.path.abspath(directory)
        self.monitor, self.max_to_keep = monitor, int(max_to_keep)
        self._best_dir = os.path.join(self.directory, "best")
        self._last_dir = os.path.join(self.directory, "last")
        os.makedirs(self._best_dir, exist_ok=True)
        os.makedirs(self._last_dir, exist_ok=True)
        self._history: dict = {}
        meta_path = os.path.join(self.directory, "best_meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as fp:
                self._history = {int(k): v for k, v in json.load(fp).get("history", {}).items()}
        if configs is not None:
            with open(os.path.join(self.directory, "configs.json"), "w") as fp:
                json.dump(configs, fp, indent=2, default=str)

    def _rank_key(self, step: int):
        return (self._history.get(step, float("inf")), -step)  # ties: the newer first

    def save(self, step: int, state: Any, metrics: dict):
        metrics = {k: float(v) for k, v in metrics.items() if isinstance(v, (int, float))}
        payload = {"state": state, "metrics": metrics, "step": int(step)}
        _atomic_save(payload, os.path.join(self._best_dir, f"{step}.pt"))
        _atomic_save(payload, os.path.join(self._last_dir, f"{step}.pt"))
        for s in _steps(self._last_dir):
            if s != step:
                os.remove(os.path.join(self._last_dir, f"{s}.pt"))
        self._history[int(step)] = metrics.get(self.monitor, float("inf"))
        kept = sorted(_steps(self._best_dir), key=self._rank_key)
        for s in kept[self.max_to_keep:]:
            os.remove(os.path.join(self._best_dir, f"{s}.pt"))
        best_step = min(self._history, key=self._rank_key)
        with open(os.path.join(self.directory, "best_meta.json"), "w") as fp:
            json.dump({"monitor": self.monitor, "best_step": best_step, "history": self._history}, fp)

    def best_step(self) -> Optional[int]:
        steps = _steps(self._best_dir)
        return min(steps, key=self._rank_key) if steps else None

    def latest_step(self) -> Optional[int]:
        steps = _steps(self._last_dir)
        return steps[-1] if steps else None

    def all_best_steps(self):
        return _steps(self._best_dir)

    def restore(self, step: Optional[int] = None, which: str = "last", map_location=None) -> Any:
        """The saved state of ``step`` (default: the latest for
        ``which="last"``, the best for ``which="best"``)."""
        if which not in ("last", "best"):
            raise ValueError(f"which must be 'last' or 'best', got {which!r}")
        d = self._last_dir if which == "last" else self._best_dir
        if step is None:
            step = self.latest_step() if which == "last" else self.best_step()
        if step is None or not os.path.exists(os.path.join(d, f"{step}.pt")):
            raise FileNotFoundError(f"no {which} checkpoint{'' if step is None else f' for step {step}'} "
                                    f"in {self.directory}")
        payload = torch.load(os.path.join(d, f"{step}.pt"), map_location=map_location, weights_only=True)
        return payload["state"]


def load_params(path: str, map_location="cpu") -> dict:
    """The model parameters saved at ``path``: a ``CheckpointManager``
    directory (its best step), one of its ``.pt`` files, a saved state dict
    (under ``state_dict`` or bare), or a Flax ``.msgpack`` blob (the shipped
    checkpoints under ``saved_checkpoints/``).  A ``.msgpack`` path gives the
    JAX package's parameter tree as ``{"params": tree}`` of numpy arrays, as
    the JAX package's ``load_params`` does (``load_reference_params`` maps
    it to the reference layout)."""
    if str(path).endswith(".msgpack"):
        tree = read_msgpack(path)
        return tree if "params" in tree else {"params": tree}
    if os.path.isdir(path):
        return CheckpointManager(path).restore(which="best", map_location=map_location)["params"]
    ckpt = torch.load(path, map_location=map_location, weights_only=True)
    if "state" in ckpt:
        return ckpt["state"]["params"]
    return ckpt.get("state_dict", ckpt)


def is_jax_tree(params) -> bool:
    """True for the JAX package's nested parameter tree (``{"params": {...}}``,
    what ``load_params`` gives for a ``.msgpack`` blob), False for a state
    dict of tensors."""
    return isinstance(params, dict) and isinstance(params.get("params"), dict)


def load_reference_params(path: str, model_cfg: dict, kind: str = "sr", map_location="cpu") -> dict:
    """The model parameters saved at ``path`` as a reference-layout state
    dict, whatever the file (``load_params``): a Flax ``.msgpack`` tree is
    mapped with ``tools/convert.py::params_from_jax`` (``kind="sr"``,
    ``model_cfg`` the ``flow_model`` config) or ``::pf_params_from_jax``
    (``kind="pf"``, the ``pf_model`` config)."""
    from ..tools.convert import params_from_jax, pf_params_from_jax

    if kind not in ("sr", "pf"):
        raise ValueError(f"kind must be 'sr' or 'pf', got {kind!r}")
    params = load_params(path, map_location)
    if not is_jax_tree(params):
        return params
    return (params_from_jax if kind == "sr" else pf_params_from_jax)(params, model_cfg)
