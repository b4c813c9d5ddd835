"""JAX-package parameter tree <-> the port's ``state_dict``.

``params_from_jax`` takes the JAX package's FlowModel parameters as nested
dicts of numpy arrays (``transformer/layers_0/mha/linear_q/kernel`` ...) and
returns tensors under the reference checkpoint's key layout, the one the
port's modules use: ``net.`` prefix, ``Dense.net.{i}`` Sequential slots,
``adaLN_modulation.1``, Flax ``kernel`` (in, out) transposed to
``nn.Linear.weight`` (out, in), LayerNorm ``scale`` -> ``weight``.
``params_to_jax`` is the reverse map.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch


def dense_linear_indices(dense_config: dict, n_hidden: Optional[int] = None):
    """Sequential indices of the Linear modules ``Dense`` builds from this
    config: per layer — optional norm, optional dropout, Linear, then an
    activation on hidden layers (or ``final_activation`` on the last)."""
    hidden = dense_config.get("hidden_layers", [])
    n_layers = (len(hidden) if n_hidden is None else n_hidden) + 1
    norm = dense_config.get("norm_layer")
    norm_final = bool(dense_config.get("norm_final_layer", False))
    dropout = float(dense_config.get("dropout", 0.0) or 0.0)
    final_act = dense_config.get("final_activation")

    idx, out = 0, []
    for i in range(n_layers):
        is_final = i == n_layers - 1
        if norm and (norm_final or not is_final):
            idx += 1
        if dropout and (norm_final or not is_final):
            idx += 1
        out.append(idx)
        idx += 1
        if not is_final:
            idx += 1
        elif final_act:
            idx += 1
    return out


def _get(tree: dict, *path):
    node = tree
    for k in path:
        if not isinstance(node, dict) or k not in node:
            return None
        node = node[k]
    return node


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _linear_pairs(jpath, tkey):
    return [(jpath + ("kernel",), f"{tkey}.weight", True), (jpath + ("bias",), f"{tkey}.bias", False)]


def _dense_pairs(jpath, tkey, dense_cfg, n_hidden=None):
    n_hidden = len(dense_cfg.get("hidden_layers") or []) if n_hidden is None else n_hidden
    out = []
    for j, slot in enumerate(dense_linear_indices(dense_cfg, n_hidden=n_hidden)):
        out += _linear_pairs(jpath + (f"linear_{j}",), f"{tkey}.net.{slot}")
    return out


def _layernorm_pairs(jpath, tkey):
    return [(jpath + ("scale",), f"{tkey}.weight", False), (jpath + ("bias",), f"{tkey}.bias", False)]


def flow_key_pairs(flow_config: dict, n_layers: Optional[int] = None):
    """Every FlowModel parameter as (JAX path, reference key without
    ``net.``, transposed?) — Flax ``kernel`` (in, out) is the transpose of
    ``nn.Linear.weight`` (out, in).  The counterpart of the JAX package's
    ``tools/torch_export.py`` layout rules."""
    cfg = flow_config
    pairs = _linear_pairs(("time_step_embedder", "mlp_0"), "time_step_embedder.mlp.0")
    pairs += _linear_pairs(("time_step_embedder", "mlp_2"), "time_step_embedder.mlp.2")
    pairs.append((("layer_emb_table", "embedding"), "layer_emb_table.weight", False))
    for name, dcfg in (
        ("layer_emb_net", cfg["layer_emb"]["dense_config"]),
        ("etaphi_emb_net", cfg["etaphi_emb"]),
        ("proxy_emb_net", cfg["e_proxy_emb"]),
        ("noisy_input_emb_net", cfg["noisy_input_emb"]),
        ("feat_0_mlp", cfg["feat_0_mlp"]),
        ("v_t_pred_net", cfg["v_t_pred"]),
    ):
        pairs += _dense_pairs((name,), name, dcfg)
    mlp_cfg = cfg["transformer"]["dense_config"]
    n_layers = int(cfg["transformer"]["num_transformer_layers"]) if n_layers is None else n_layers
    for i in range(n_layers):
        jp, tp = ("transformer", f"layers_{i}"), f"transformer.layers.{i}"
        for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
            pairs += _linear_pairs(jp + ("mha", name), f"{tp}.mha.{name}")
        pairs += _dense_pairs(jp + ("dense",), f"{tp}.dense", mlp_cfg)
        pairs += _layernorm_pairs(jp + ("norm1",), f"{tp}.norm1")
        pairs += _layernorm_pairs(jp + ("norm2",), f"{tp}.norm2")
        pairs += _linear_pairs(jp + ("adaLN_modulation",), f"{tp}.adaLN_modulation.1")
    pairs += _layernorm_pairs(("transformer", "final_norm"), "transformer.final_norm")
    pairs += _linear_pairs(("transformer", "final_linear"), "transformer.final_linear")
    pairs += _linear_pairs(("v_t_adaLN_modulation",), "v_t_adaLN_modulation.1")
    pairs += _layernorm_pairs(("norm_v_t",), "norm_v_t")
    return pairs


def _fill(out, node, pairs):
    """Convert the leaves of ``node`` named by ``pairs`` into ``out``."""
    for jpath, key, transpose in pairs:
        leaf = _get(node, *jpath)
        if leaf is not None:
            arr = np.asarray(leaf, np.float32)
            out[key] = _t(arr.T if transpose else arr)


def _linear(out, node, key):
    if node is not None and "kernel" in node:
        _fill(out, node, _linear_pairs((), key))


def _dense(out, node, key, dense_cfg):
    if node is not None:
        n_hidden = sum(k.startswith("linear_") for k in node) - 1
        _fill(out, node, _dense_pairs((), key, dense_cfg, n_hidden))


def _layernorm(out, node, key):
    if node is not None and "scale" in node:
        _fill(out, node, _layernorm_pairs((), key))


def _n_layers_jax(tree) -> int:
    stack = _get(tree, "transformer") or {}
    n = 0
    while f"layers_{n}" in stack:
        n += 1
    return n


def unflatten(flat: Dict[str, Any], sep: str = "/") -> dict:
    """{'a/b/c': x} -> {'a': {'b': {'c': x}}} (for npz-stored trees)."""
    tree: dict = {}
    for k, v in flat.items():
        node = tree
        parts = k.split(sep)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def params_from_jax(params: Dict[str, Any], flow_config: dict) -> Dict[str, torch.Tensor]:
    """JAX-package FlowModel params (nested dicts of numpy arrays, with or
    without the top-level ``{"params": ...}``) -> ``net.*`` state dict for
    ``FlowModel.load_reference_state_dict``.  Leaves the tree does not hold
    are left out."""
    tree = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    _fill(out, tree, flow_key_pairs(flow_config, _n_layers_jax(tree)))
    return {f"net.{k}": v for k, v in out.items()}


def params_to_jax(state_dict: Dict[str, Any], flow_config: dict) -> dict:
    """The reverse of ``params_from_jax``: a FlowModel ``state_dict`` (keys
    with or without ``net.``) -> the JAX package's parameter tree of fp32
    numpy arrays (the layout ``FlowModel.init`` gives).  Counterpart of the
    JAX package's ``tools/torch_export.py::export_flow_params``."""
    sd = {(k[4:] if k.startswith("net.") else k): v for k, v in state_dict.items()}
    n_layers = len({k.split(".")[2] for k in sd if k.startswith("transformer.layers.")})
    tree: dict = {}
    for jpath, key, transpose in flow_key_pairs(flow_config, n_layers):
        if key not in sd:
            continue
        v = sd[key]
        arr = (v.detach().float().cpu().numpy() if torch.is_tensor(v) else np.asarray(v, np.float32))
        node = tree
        for p in jpath[:-1]:
            node = node.setdefault(p, {})
        node[jpath[-1]] = np.ascontiguousarray(arr.T if transpose else arr)
    return tree


def init_params_jax_layout(flow_config: dict, seed: int = 0) -> dict:
    """Random FlowModel parameters as a numpy tree in the JAX package's
    layout, drawn from ``seed``: Xavier-uniform kernels (in, out) and zero
    biases for EVERY linear (the adaLN modulation nets included, as the JAX
    package's ``FlowModel.init`` gives — not the trainer's zero-init policy,
    under which every gate is 0), N(0, 1) layer-embedding table, LayerNorm
    scale 1 / bias 0.  Pass the result through ``params_from_jax``."""
    rng = np.random.default_rng(seed)
    cfg = flow_config

    def linear(n_in, n_out):
        bound = float(np.sqrt(6.0 / (n_in + n_out)))
        return {
            "kernel": rng.uniform(-bound, bound, (n_in, n_out)).astype(np.float32),
            "bias": np.zeros(n_out, np.float32),
        }

    def dense(dense_cfg, n_in, context):
        sizes = [*(dense_cfg.get("hidden_layers") or ()), dense_cfg["output_size"]]
        node, width = {}, n_in + context
        for i, size in enumerate(sizes):
            node[f"linear_{i}"] = linear(width, size)
            width = size
        return node

    def norm(n):
        return {"scale": np.ones(n, np.float32), "bias": np.zeros(n, np.float32)}

    C = int(cfg["time_embedding_size"])
    h = int(cfg["h_dim"])
    emb_dim = int(cfg["layer_emb"]["emb_dim"])
    cond = (
        cfg["etaphi_emb"]["output_size"] + cfg["layer_emb"]["dense_config"]["output_size"]
        + cfg["e_proxy_emb"]["output_size"] + 1
    )
    ctx = C + cond
    tcfg = cfg["transformer"]
    tree = {
        "time_step_embedder": {"mlp_0": linear(256, C), "mlp_2": linear(C, C)},
        "layer_emb_table": {"embedding": rng.normal(size=(3, emb_dim)).astype(np.float32)},
        "layer_emb_net": dense(cfg["layer_emb"]["dense_config"], emb_dim, C),
        "etaphi_emb_net": dense(cfg["etaphi_emb"], 3, C),
        "proxy_emb_net": dense(cfg["e_proxy_emb"], 1, C),
        "noisy_input_emb_net": dense(cfg["noisy_input_emb"], 1, C),
        "feat_0_mlp": dense(cfg["feat_0_mlp"], cond + cfg["noisy_input_emb"]["output_size"], ctx),
        "v_t_pred_net": dense(cfg["v_t_pred"], h + cond, ctx),
        "transformer": {"final_norm": norm(h)},
    }
    for i in range(int(tcfg["num_transformer_layers"])):
        tree["transformer"][f"layers_{i}"] = {
            "mha": {name: linear(h, h) for name in ("linear_q", "linear_k", "linear_v", "linear_out")},
            "dense": dense(dict(tcfg["dense_config"], output_size=h), h, 0),
            "norm1": norm(h),
            "norm2": norm(h),
            "adaLN_modulation": linear(ctx, 6 * h),
        }
    if cfg.get("final_modulation", False):
        tree["v_t_adaLN_modulation"] = linear(ctx, 2 * (h + cond))
        tree["norm_v_t"] = norm(h + cond)
    return tree
