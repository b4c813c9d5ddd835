"""JAX-package parameter tree <-> the port's ``state_dict``.

``params_from_jax`` takes the JAX package's FlowModel parameters as nested
dicts of numpy arrays (``transformer/layers_0/mha/linear_q/kernel`` ...) and
returns tensors under the reference checkpoint's key layout, the one the
port's modules use: ``net.`` prefix, ``Dense.net.{i}`` Sequential slots,
``adaLN_modulation.1``, Flax ``kernel`` (in, out) transposed to
``nn.Linear.weight`` (out, in), LayerNorm ``scale`` -> ``weight``.
``params_to_jax`` is the reverse map; ``pf_params_from_jax`` and
``pf_params_to_jax`` do the same for the stage-2 model (SAPF).
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


def _dit_stack_pairs(jpath, tkey, mlp_cfg, n_layers):
    """A DiTEncoder's parameters: per layer the attention's four linears, the
    MLP, both LayerNorms and the adaLN modulation (Sequential slot 1), then
    the final LayerNorm and the optional final linear."""
    pairs = []
    for i in range(n_layers):
        jp, tp = jpath + (f"layers_{i}",), f"{tkey}.layers.{i}"
        for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
            pairs += _linear_pairs(jp + ("mha", name), f"{tp}.mha.{name}")
        pairs += _dense_pairs(jp + ("dense",), f"{tp}.dense", mlp_cfg)
        pairs += _layernorm_pairs(jp + ("norm1",), f"{tp}.norm1")
        pairs += _layernorm_pairs(jp + ("norm2",), f"{tp}.norm2")
        pairs += _linear_pairs(jp + ("adaLN_modulation",), f"{tp}.adaLN_modulation.1")
    pairs += _layernorm_pairs(jpath + ("final_norm",), f"{tkey}.final_norm")
    pairs += _linear_pairs(jpath + ("final_linear",), f"{tkey}.final_linear")
    return pairs


def _normformer_stack_pairs(jpath, tkey, mlp_cfg, n_layers):
    """A Normformer TransformerEncoder's parameters (no edges): per layer the
    attention's four linears, both LayerNorms and the MLP, then the final
    LayerNorm and the optional final linear."""
    pairs = []
    for i in range(n_layers):
        jp, tp = jpath + (f"layers_{i}",), f"{tkey}.layers.{i}"
        for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
            pairs += _linear_pairs(jp + ("mha", name), f"{tp}.mha.{name}")
        pairs += _layernorm_pairs(jp + ("norm1",), f"{tp}.norm1")
        pairs += _layernorm_pairs(jp + ("norm2",), f"{tp}.norm2")
        pairs += _dense_pairs(jp + ("dense",), f"{tp}.dense", mlp_cfg)
    pairs += _layernorm_pairs(jpath + ("final_norm",), f"{tkey}.final_norm")
    pairs += _linear_pairs(jpath + ("final_linear",), f"{tkey}.final_linear")
    return pairs


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
    n_layers = int(cfg["transformer"]["num_transformer_layers"]) if n_layers is None else n_layers
    stack = _normformer_stack_pairs if cfg["transformer"]["type"] == "GPT-2+Normformer" else _dit_stack_pairs
    pairs += stack(("transformer",), "transformer", cfg["transformer"]["dense_config"], n_layers)
    pairs += _linear_pairs(("v_t_adaLN_modulation",), "v_t_adaLN_modulation.1")
    pairs += _layernorm_pairs(("norm_v_t",), "norm_v_t")
    return pairs


def _fill(out, node, pairs):
    """Convert the leaves of ``node`` named by ``pairs`` into ``out``."""
    for jpath, key, transpose in pairs:
        leaf = _get(node, *jpath)
        if leaf is not None:
            arr = leaf.float().numpy() if torch.is_tensor(leaf) else np.asarray(leaf, np.float32)
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


def _n_layers_jax(tree, *path) -> int:
    stack = _get(tree, *(path or ("transformer",))) or {}
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
    sd = _strip_net(state_dict)
    n_layers = len({k.split(".")[2] for k in sd if k.startswith("transformer.layers.")})
    return _to_tree(sd, flow_key_pairs(flow_config, n_layers))


def _strip_net(state_dict):
    return {(k[4:] if k.startswith("net.") else k): v for k, v in state_dict.items()}


def _to_tree(sd, pairs) -> dict:
    """The leaves of ``sd`` named by ``pairs`` as a JAX-layout tree of fp32
    numpy arrays (kernels transposed back)."""
    tree: dict = {}
    for jpath, key, transpose in pairs:
        if key not in sd:
            continue
        v = sd[key]
        arr = (v.detach().float().cpu().numpy() if torch.is_tensor(v) else np.asarray(v, np.float32))
        node = tree
        for p in jpath[:-1]:
            node = node.setdefault(p, {})
        node[jpath[-1]] = np.ascontiguousarray(arr.T if transpose else arr)
    return tree


# random parameters in the JAX layout (Flax's init distributions), from a numpy generator
def _init_linear(rng, n_in, n_out):
    bound = float(np.sqrt(6.0 / (n_in + n_out)))  # Xavier uniform, zero bias
    return {"kernel": rng.uniform(-bound, bound, (n_in, n_out)).astype(np.float32),
            "bias": np.zeros(n_out, np.float32)}


def _init_dense(rng, dense_cfg, n_in):
    sizes = [*(dense_cfg.get("hidden_layers") or ()), dense_cfg["output_size"]]
    node, width = {}, n_in
    for i, size in enumerate(sizes):
        node[f"linear_{i}"] = _init_linear(rng, width, size)
        width = size
    return node


def _init_norm(n):
    return {"scale": np.ones(n, np.float32), "bias": np.zeros(n, np.float32)}


def _init_dit_layer(rng, h, ctx, mlp_cfg):
    return {
        "mha": {name: _init_linear(rng, h, h) for name in ("linear_q", "linear_k", "linear_v", "linear_out")},
        "dense": _init_dense(rng, dict(mlp_cfg, output_size=h), h),
        "norm1": _init_norm(h),
        "norm2": _init_norm(h),
        "adaLN_modulation": _init_linear(rng, ctx, 6 * h),
    }


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
        return _init_linear(rng, n_in, n_out)

    def dense(dense_cfg, n_in, context):
        return _init_dense(rng, dense_cfg, n_in + context)

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
        "etaphi_emb_net": dense(cfg["etaphi_emb"], 3 + 4 * int(cfg["etaphi_emb"].get("fourier_features", 0) or 0), C),
        "proxy_emb_net": dense(cfg["e_proxy_emb"], 1, C),
        "noisy_input_emb_net": dense(cfg["noisy_input_emb"], 1, C),
        "feat_0_mlp": dense(cfg["feat_0_mlp"], cond + cfg["noisy_input_emb"]["output_size"], ctx),
        "v_t_pred_net": dense(cfg["v_t_pred"], h + cond, ctx),
        "transformer": {"final_norm": _init_norm(h)},
    }
    for i in range(int(tcfg["num_transformer_layers"])):
        if tcfg["type"] == "GPT-2+Normformer":
            mlp_in = h + int(tcfg["dense_config"].get("context_size", 0) or 0)
            layer = {"mha": {name: _init_linear(rng, h, h) for name in ("linear_q", "linear_k", "linear_v",
                                                                         "linear_out")},
                     "norm1": _init_norm(h), "norm2": _init_norm(h),
                     "dense": _init_dense(rng, dict(tcfg["dense_config"], output_size=h), mlp_in)}
        else:
            layer = _init_dit_layer(rng, h, ctx, tcfg["dense_config"])
        tree["transformer"][f"layers_{i}"] = layer
    if cfg.get("final_modulation", False):
        tree["v_t_adaLN_modulation"] = linear(ctx, 2 * (h + cond))
        tree["norm_v_t"] = _init_norm(h + cond)
    return tree


# ---------------------------------------------------------------------------
# stage 2: SAPF
# ---------------------------------------------------------------------------


def pf_key_pairs(config_pf: dict, tree: Optional[dict] = None, n_layers: Optional[tuple] = None):
    """Every SAPF parameter as (JAX path, reference key without ``net.``,
    transposed?): the layout of the JAX package's
    ``tools/torch_export.py::export_pf_params``.  ``tree`` (a JAX parameter
    tree) decides the names that vary: the layer embedding (``layer_emb_net``,
    or the older ``layer_emb_table``), the slots (embedding or random) and the
    kinematic head; ``n_layers`` = (encoder, kinematics) DiT depths (default:
    the tree's, else the config's)."""
    enc_t = config_pf["encoder"]["transformer"]
    kcfg = config_pf.get("kinematics_predictor")
    if n_layers is None:
        n_layers = (int(enc_t["num_transformer_layers"]),
                    int(kcfg["transformer"]["num_transformer_layers"]) if kcfg else 0)
        if tree is not None:
            n_layers = (_n_layers_jax(tree, "encoder", "transformer") or n_layers[0],
                        _n_layers_jax(tree, "kinematics_predictor", "transformer") or n_layers[1])
    emb = "layer_emb_table" if tree is not None and _get(tree, "encoder", "layer_emb_table") is not None \
        else "layer_emb_net"
    pairs = [(("encoder", emb, "embedding"), "encoder.layer_emb_net.weight", False)]
    pairs += _linear_pairs(("encoder", "cell_init_0"), "encoder.cell_init_net.0")
    pairs += _linear_pairs(("encoder", "cell_init_1"), "encoder.cell_init_net.2")
    pairs += _dit_stack_pairs(("encoder", "transformer"), "encoder.transformer", enc_t["dense_config"], n_layers[0])
    if config_pf.get("cardinality_predictor") is not None:
        head = dict(config_pf["cardinality_predictor"], output_size=int(config_pf["max_particles"]) + 1)
        pairs += _dense_pairs(("cardinality_predictor", "card_pred_net"), "cardinality_predictor.card_pred_net",
                              head)
    if kcfg is not None:
        kp, tk = ("kinematics_predictor",), "kinematics_predictor"
        if kcfg["init_particles"]["type"] == "embedding":
            pairs.append((kp + ("particle_emb_net", "embedding"), f"{tk}.particle_emb_net.weight", False))
            pairs += _linear_pairs(kp + ("particle_proj",), f"{tk}.particle_proj")
        else:
            pairs += [(kp + ("edges_mu",), f"{tk}.edges_mu", False),
                      (kp + ("edges_logsigma",), f"{tk}.edges_logsigma", False)]
        pairs += _dit_stack_pairs(kp + ("transformer",), f"{tk}.transformer", kcfg["transformer"]["dense_config"],
                                  n_layers[1])
        if kcfg.get("use_attn_kinematics", False):
            pairs += _linear_pairs(kp + ("kin_net", "linear_q"), f"{tk}.kin_net.linear_q")
            pairs += _linear_pairs(kp + ("kin_net", "linear_k"), f"{tk}.kin_net.linear_k")
        else:
            pairs += _dense_pairs(kp + ("kin_net",), f"{tk}.kin_net", kcfg["pt_eta_phi_e_net"])
    return pairs


def pf_params_from_jax(params: Dict[str, Any], config_pf: dict) -> Dict[str, torch.Tensor]:
    """JAX-package SAPF params (nested dicts of numpy arrays, with or without
    the top-level ``{"params": ...}``) -> ``net.*`` state dict for
    ``SAPF.load_reference_state_dict`` (strict).  Counterpart of
    ``export_pf_params``."""
    tree = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    _fill(out, tree, pf_key_pairs(config_pf, tree))
    return {f"net.{k}": v for k, v in out.items()}


def pf_params_to_jax(state_dict: Dict[str, Any], config_pf: dict) -> dict:
    """The reverse of ``pf_params_from_jax``: an SAPF ``state_dict`` (keys
    with or without ``net.``) -> the JAX package's parameter tree of fp32
    numpy arrays (the layout ``SAPF.init`` gives)."""
    sd = _strip_net(state_dict)

    def depth(prefix):
        return len({k.split(".")[3] for k in sd if k.startswith(prefix)})

    n_layers = (depth("encoder.transformer.layers."), depth("kinematics_predictor.transformer.layers."))
    return _to_tree(sd, pf_key_pairs(config_pf, n_layers=n_layers))


def init_pf_params_jax_layout(config_pf: dict, seed: int = 0) -> dict:
    """Random SAPF parameters as a numpy tree in the JAX package's layout,
    drawn from ``seed``, with the distributions of ``SAPF.init``:
    Xavier-uniform kernels and zero biases for every linear, embedding tables
    N(0, 1/features) (Flax's default embedding init), LayerNorm scale 1 /
    bias 0, random slots mu N(0, 1) and logsigma Xavier-uniform of a
    (1, 1, h) leaf.  The trainer's init policies are applied on top of it.
    Pass the result through ``pf_params_from_jax``."""
    rng = np.random.default_rng(seed)
    h = int(config_pf["h_dim"])

    def linear(n_in, n_out):
        return _init_linear(rng, n_in, n_out)

    def embed(n, d):
        return {"embedding": (rng.normal(size=(n, d)) / np.sqrt(d)).astype(np.float32)}

    def dit(tcfg):
        node = {"final_norm": _init_norm(h)}
        for i in range(int(tcfg["num_transformer_layers"])):
            node[f"layers_{i}"] = _init_dit_layer(rng, h, h, tcfg["dense_config"])
        return node

    enc = config_pf["encoder"]
    emb_dim = int(enc["layer_emb_dim"])
    tree = {"encoder": {"layer_emb_net": embed(3, emb_dim), "cell_init_0": linear(4 + emb_dim, h),
                        "cell_init_1": linear(h, h), "transformer": dit(enc["transformer"])}}
    if config_pf.get("cardinality_predictor") is not None:
        head = dict(config_pf["cardinality_predictor"], output_size=int(config_pf["max_particles"]) + 1)
        tree["cardinality_predictor"] = {"card_pred_net": _init_dense(rng, head, h)}
    kcfg = config_pf.get("kinematics_predictor")
    if kcfg is not None:
        node = {"transformer": dit(kcfg["transformer"])}
        init = kcfg["init_particles"]
        if init["type"] == "embedding":
            node["particle_emb_net"] = embed(int(config_pf["max_particles"]), int(init["embedding_dim"]))
            node["particle_proj"] = linear(int(init["embedding_dim"]), h)
        else:
            bound = float(np.sqrt(6.0 / (1 + h)))
            node["edges_mu"] = rng.normal(size=(1, 1, h)).astype(np.float32)
            node["edges_logsigma"] = rng.uniform(-bound, bound, (1, 1, h)).astype(np.float32)
        if kcfg.get("use_attn_kinematics", False):
            node["kin_net"] = {"linear_q": linear(h, h), "linear_k": linear(h, h)}
        else:
            node["kin_net"] = _init_dense(rng, kcfg["pt_eta_phi_e_net"], h)
        tree["kinematics_predictor"] = node
    return tree
