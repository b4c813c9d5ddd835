"""PyTorch port, the general attention path and the GPT-2 + Normformer encoder
against the JAX package (fp32, CPU, same weights): attention with edge
features, bias, adjacency mask and edge updates on the cases of
``tests/test_edge_attention.py``; the Normformer encoder with edge updates and
its cross-attention layer; a FlowModel with ``type: GPT-2+Normformer`` and its
parameter converter; the pre-softmax score dropout (eval mode equal to the
JAX module's deterministic path; train mode dropping the expected share,
from an explicit generator).  Tolerance 1e-5: fp32 on both sides, another
summation order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolutionhep_tpu.models.attention import MultiheadAttention as JMHA
from superresolutionhep_tpu.models.flow_model import FlowModel as JFlowModel
from superresolutionhep_tpu.models.transformer import TransformerCrossAttentionLayer as JCross
from superresolutionhep_tpu.models.transformer import TransformerEncoder as JEncoder
from superresolutionhep_tpu_torch.configs import MULTIPART_CONFIG_MV
from superresolutionhep_tpu_torch.models.attention import MultiheadAttention, score_dropout
from superresolutionhep_tpu_torch.models.flow_model import FlowModel
from superresolutionhep_tpu_torch.models.transformer import TransformerCrossAttentionLayer, TransformerEncoder
from superresolutionhep_tpu_torch.tools import convert

torch.set_num_threads(1)
MHA_NAMES = ("linear_q", "linear_k", "linear_v", "linear_out", "linear_e", "linear_g", "linear_e_out")
DENSE = {"hidden_layers": [16], "activation": "ReLU"}


def _randomized(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda a: (np.asarray(a) + 0.1 * rng.normal(size=a.shape)).astype(np.float32),
                                  tree)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _mha_sd(out, node, key):
    for name in MHA_NAMES:
        if name in node:
            convert._linear(out, node[name], f"{key}.{name}")


def _layer_sd(out, node, key, dense_cfg):
    _mha_sd(out, node["mha"], f"{key}.mha")
    for name in ("norm0", "norm1", "norm2", "enorm1", "enorm2"):
        convert._layernorm(out, node.get(name), f"{key}.{name}")
    convert._dense(out, node.get("dense"), f"{key}.dense", dict(dense_cfg, output_size=0))


def _load(module, sd):
    res = module.load_state_dict(sd, strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    return module.eval()


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=0)


def test_mha_with_edges_matches_jax():
    """The case of ``test_mha_with_edges_returns_edge_out``: edges, edge
    updates and a padding mask; the gate case (edges - 100); an additive
    bias and an adjacency mask together with the edges."""
    B, L, F, E = 2, 6, 16, 8
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, L, F)).astype(np.float32)
    edges = rng.normal(size=(B, L, L, E)).astype(np.float32)
    valid = np.array([[True] * 6, [True] * 4 + [False] * 2])
    bias = rng.normal(size=(B, L, L, 4)).astype(np.float32)
    adj = (rng.uniform(size=(B, L, L)) < 0.5) | np.eye(L, dtype=bool)[None]
    jm = JMHA(embed_dim=16, num_heads=4, edge_embed_dim=E, update_edges=True, impl="xla")
    params = _randomized(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), edges=jnp.asarray(edges),
                                 q_valid=jnp.asarray(valid))["params"], 1)
    sd = {}
    _mha_sd(sd, params, "")
    tm = _load(MultiheadAttention(16, 4, edge_embed_dim=E, update_edges=True), {k[1:]: v for k, v in sd.items()})
    for e, extra in ((edges, {}), (edges - 100.0, {}), (edges, {"attn_bias": bias, "attn_valid": adj})):
        want, want_e = jm.apply({"params": params}, jnp.asarray(x), edges=jnp.asarray(e), q_valid=jnp.asarray(valid),
                                **{k: jnp.asarray(v) for k, v in extra.items()})
        with torch.no_grad():
            got, got_e = tm(_t(x), edges=_t(e), q_valid=_t(valid), **{k: _t(v) for k, v in extra.items()})
        assert got.shape == (B, L, 16) and got_e.shape == (B, L, L, E)
        _close(got, want)
        _close(got_e, want_e, 1e-4 * max(1.0, float(np.abs(np.asarray(want_e)).max())))


def test_normformer_encoder_and_cross_layer_match_jax():
    """The case of ``test_normformer_encoder_with_edge_updates``: 3 layers,
    edge updates (none in the last layer, which has no ``linear_e_out``),
    gradients finite; and the cross-attention layer with both masks."""
    B, L, F, E = 2, 5, 16, 8
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, L, F)).astype(np.float32)
    edges = rng.normal(size=(B, L, L, E)).astype(np.float32)
    valid = np.array([[True] * 5, [True] * 3 + [False] * 2])
    jenc = JEncoder(embed_dim=F, num_layers=3, num_heads=4, dense_config=DENSE, edge_embed_dim=E,
                    update_edges=True, attn_impl="xla")
    params = _randomized(jenc.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(edges),
                                   valid=jnp.asarray(valid))["params"], 2)
    assert "linear_e_out" not in params["layers_2"]["mha"]
    want = jenc.apply({"params": params}, jnp.asarray(x), jnp.asarray(edges), valid=jnp.asarray(valid))
    sd = {}
    for i in range(3):
        _layer_sd(sd, params[f"layers_{i}"], f"layers.{i}", DENSE)
    convert._layernorm(sd, params["final_norm"], "final_norm")
    enc = _load(TransformerEncoder(F, 3, 4, dense_config=DENSE, edge_embed_dim=E, update_edges=True), sd)
    assert not hasattr(enc.layers[2].mha, "linear_e_out")
    got = enc(_t(x), _t(edges), valid=_t(valid))
    assert got.shape == (B, L, F)
    _close(got.detach(), want)
    (got ** 2).sum().backward()
    assert all(torch.isfinite(p.grad).all() for p in enc.parameters() if p.grad is not None)

    q = rng.normal(size=(B, 4, F)).astype(np.float32)
    q_valid = np.array([[True] * 4, [True, True, False, False]])
    jx = JCross(embed_dim=F, num_heads=4, dense_config=DENSE, attn_impl="xla")
    jkw = dict(query_valid=jnp.asarray(q_valid), key_value_valid=jnp.asarray(valid))
    cparams = _randomized(jx.init(jax.random.PRNGKey(1), jnp.asarray(q), jnp.asarray(x), **jkw)["params"], 3)
    want = jx.apply({"params": cparams}, jnp.asarray(q), jnp.asarray(x), **jkw)
    sd = {}
    _layer_sd(sd, cparams, "", DENSE)
    cross = _load(TransformerCrossAttentionLayer(F, 4, dense_config=DENSE), {k[1:]: v for k, v in sd.items()})
    with torch.no_grad():
        got = cross(_t(q), _t(x), query_valid=_t(q_valid), key_value_valid=_t(valid))
    _close(got, want)


def _normformer_config():
    cfg = dict(MULTIPART_CONFIG_MV["flow_model"], h_dim=64)
    cfg["feat_0_mlp"] = dict(cfg["feat_0_mlp"], output_size=64)
    cfg["transformer"] = dict(cfg["transformer"], type="GPT-2+Normformer", num_transformer_layers=2,
                              dense_config=dict(cfg["transformer"]["dense_config"], hidden_layers=[64]))
    return cfg


@pytest.mark.parametrize("impl,jimpl", [("einsum", "xla"), ("flash", "flash")])
def test_normformer_flow_model_matches_jax(impl, jimpl):
    """``type: GPT-2+Normformer`` (h 64, 2 layers): the port's FlowModel on
    the converter's weights against the JAX model (its flash impl runs the
    Pallas kernel in interpret mode; the port's flash impl on a CPU tensor
    is the kernel's plain version); the random init has the JAX tree's
    shapes, and ``params_to_jax`` inverts ``params_from_jax``; a packed
    batch is refused, as in the JAX package."""
    cfg = _normformer_config()
    rng = np.random.default_rng(3)
    B, N = 2, 128
    phi = rng.uniform(-3, 3, size=(B, N, 1)).astype(np.float32)
    batch = {"eta": rng.uniform(-1, 1, size=(B, N, 1)).astype(np.float32), "cosphi": np.cos(phi),
             "sinphi": np.sin(phi), "layer": rng.integers(0, 3, size=(B, N, 1)).astype(np.int32),
             "e_proxy": rng.normal(size=(B, N, 1)).astype(np.float32),
             "q_mask": np.arange(N)[None, :] < np.array([[N], [77]])}
    x = rng.normal(size=(B, N, 1)).astype(np.float32)
    t = np.array([0.1, 0.6], np.float32)
    params = _randomized(convert.init_params_jax_layout(cfg, seed=4), 5)
    jm = JFlowModel(config=cfg, attn_impl=jimpl)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jb, jnp.asarray(x), jnp.asarray(t))["params"]
    assert jax.tree_util.tree_map(lambda a: a.shape, shapes) == jax.tree_util.tree_map(np.shape, params)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jb, jnp.asarray(x), jnp.asarray(t)))
    sd = convert.params_from_jax(params, cfg)
    back = convert.params_to_jax(sd, cfg)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, params)
    model = FlowModel(cfg, attn_impl=impl)
    res = model.load_reference_state_dict(sd, strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    with torch.no_grad():
        got = model.eval()({k: _t(v) for k, v in batch.items()}, _t(x), _t(t)).numpy()
    m = batch["q_mask"]
    _close(got[m], want[m])
    with pytest.raises(NotImplementedError, match="DiT"):
        model({**{k: _t(v) for k, v in batch.items()}, "seg": torch.zeros(B, N, dtype=torch.int32)}, _t(x), _t(t))


def test_score_dropout_eval_equals_jax_and_train_drops_its_share():
    """dropout 0.25 on the scores: in eval mode (the JAX module's
    ``deterministic=True``) the module equals JAX's, which then takes its
    dense path; in train mode the keep mask comes from the generator: the
    same seed gives the same output, a kept score is scaled by 1/(1 - p)
    and the dropped share is p."""
    B, L, F = 2, 8, 16
    rng = np.random.default_rng(6)
    x = rng.normal(size=(B, L, F)).astype(np.float32)
    valid = np.array([[True] * 8, [True] * 5 + [False] * 3])
    jm = JMHA(embed_dim=F, num_heads=4, dropout=0.25, impl="flash")
    params = _randomized(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), q_valid=jnp.asarray(valid))["params"], 7)
    want = jm.apply({"params": params}, jnp.asarray(x), q_valid=jnp.asarray(valid), deterministic=True)
    sd = {}
    _mha_sd(sd, params, "")
    tm = _load(MultiheadAttention(F, 4, dropout=0.25, impl="flash"), {k[1:]: v for k, v in sd.items()})
    with torch.no_grad():
        _close(tm(_t(x), q_valid=_t(valid)), want)
        tm.train()
        a = tm(_t(x), q_valid=_t(valid), dropout_generator=torch.Generator().manual_seed(1))
        b = tm(_t(x), q_valid=_t(valid), dropout_generator=torch.Generator().manual_seed(1))
        c = tm(_t(x), q_valid=_t(valid), dropout_generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.allclose(a, c)
    scores = torch.full((64, 4, 64, 64), 3.0)
    out = score_dropout(scores, 0.25, torch.Generator().manual_seed(0))
    kept = out != 0
    assert torch.all(out[kept] == 4.0)
    assert abs(1.0 - kept.float().mean().item() - 0.25) < 0.005
    with pytest.raises(ValueError, match="dropout"):
        tm(_t(x), q_valid=_t(valid), fused_ln=(torch.ones(B, F), torch.zeros(B, F)))
