"""PyTorch port, model modules against the JAX package on the same numpy
inputs and the same weights (fp32, CPU): Dense, TimestepEmbedder,
MultiheadAttention, DiTLayer (fused and unfused), FlowModel against the
frozen golden, the parameter converter and the inference dtype cast.  Where
the JAX module reaches a Pallas kernel it runs in interpret mode."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from superresolutionhep_tpu.models.attention import MultiheadAttention as JMHA
from superresolutionhep_tpu.models.dense import Dense as JDense
from superresolutionhep_tpu.models.dit import DiTEncoder as JDiTEncoder
from superresolutionhep_tpu.models.dit import DiTLayer as JDiTLayer
from superresolutionhep_tpu.models.embed import TimestepEmbedder as JTimestepEmbedder
from superresolutionhep_tpu.models.embed import timestep_embedding as jtimestep_embedding
from superresolutionhep_tpu.tools.torch_export import export_flow_params
from superresolutionhep_tpu_torch.models.attention import MultiheadAttention
from superresolutionhep_tpu_torch.models.dense import Dense
from superresolutionhep_tpu_torch.models.dit import DiTEncoder, DiTLayer
from superresolutionhep_tpu_torch.models.embed import TimestepEmbedder, timestep_embedding
from superresolutionhep_tpu_torch.models.flow_model import FlowModel
from superresolutionhep_tpu_torch.models.precision import cast_params_for_inference
from superresolutionhep_tpu_torch.tools import convert

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "flow_golden.npz")

DENSE_CFG = {
    "activation": "LeakyReLU", "dropout": 0.0, "final_activation": "LeakyReLU", "hidden_layers": [128],
    "norm_final_layer": False, "norm_layer": "LayerNorm",
}


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a), tree)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _load(module, sd):
    missing = module.load_state_dict(sd, strict=True)
    assert not missing.missing_keys and not missing.unexpected_keys
    return module.eval()


def _linear_sd(out, node, key):
    convert._linear(out, node, key)
    return out


def _dit_layer_sd(p, prefix=""):
    out = {}
    for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
        convert._linear(out, p["mha"][name], f"{prefix}mha.{name}")
    convert._dense(out, p["dense"], f"{prefix}dense", DENSE_CFG)
    convert._layernorm(out, p["norm1"], f"{prefix}norm1")
    convert._layernorm(out, p["norm2"], f"{prefix}norm2")
    convert._linear(out, p["adaLN_modulation"], f"{prefix}adaLN_modulation.1")
    return out


def _randomize(params, seed):
    """Replace every leaf by seeded numpy noise (zero biases and unit LayerNorm
    scales would hide a swapped shift/scale or a dropped bias)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.normal(size=a.shape)).astype(np.float32), params)


@pytest.mark.parametrize("cfg,ctx", [
    (dict(DENSE_CFG, output_size=31, hidden_layers=[64]), 8),
    (dict(DENSE_CFG, output_size=16, hidden_layers=[]), 0),
    (dict(DENSE_CFG, output_size=1, hidden_layers=[32, 16, 8], final_activation=None), 8),
    (dict(DENSE_CFG, output_size=8, norm_layer=None, activation="SiLU", norm_final_layer=False), 0),
    (dict(DENSE_CFG, output_size=8, norm_final_layer=True), 4),
])
def test_dense_matches_jax(cfg, ctx):
    rng = np.random.default_rng(0)
    B, L, F = 2, 7, 5
    x = rng.normal(size=(B, L, F)).astype(np.float32)
    context = rng.normal(size=(B, ctx)).astype(np.float32) if ctx else None
    jcfg = dict(cfg, context_size=ctx)
    jm = JDense.from_config(jcfg)
    jc = jnp.asarray(context) if ctx else None
    params = _randomize(_np_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), context=jc)["params"]), 1)
    want = jm.apply({"params": params}, jnp.asarray(x), context=jc)
    sd = {}
    convert._dense(sd, params, "d", jcfg)
    tm = _load(Dense.from_config(jcfg, input_size=F), {k[2:]: v for k, v in sd.items()})
    with torch.no_grad():
        got = tm(_t(x), context=_t(context) if ctx else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    # Sequential slots follow the reference construction rule
    assert [int(k.split(".")[2]) for k in sorted(sd) if k.endswith("weight")] == sorted(
        convert.dense_linear_indices(jcfg))


def test_timestep_embedder_matches_jax():
    t = np.array([0.0, 0.25, 0.5, 1.0], np.float32)
    np.testing.assert_allclose(
        timestep_embedding(_t(t), 256).numpy(), np.asarray(jtimestep_embedding(jnp.asarray(t), 256)), atol=1e-6)
    assert timestep_embedding(_t(t), 7).shape == (4, 7)
    jm = JTimestepEmbedder(64)
    params = _randomize(_np_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(t))["params"]), 2)
    want = jm.apply({"params": params}, jnp.asarray(t))
    sd = {}
    convert._linear(sd, params["mlp_0"], "mlp.0")
    convert._linear(sd, params["mlp_2"], "mlp.2")
    with torch.no_grad():
        got = _load(TimestepEmbedder(64), sd)(_t(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def _valid(B, L, lens):
    return np.arange(L)[None, :] < np.asarray(lens)[:, None]


@pytest.mark.parametrize("impl,jimpl", [("einsum", "xla"), ("flash", "flash"), ("flash_nomax", "flash_nomax"),
                                        ("auto", "xla")])
def test_multihead_attention_matches_jax(impl, jimpl):
    """Padding-masked self-attention; the JAX flash impls run the Pallas
    kernels in interpret mode; 'auto' on a CPU tensor is the einsum path."""
    rng = np.random.default_rng(3)
    B, L, F, H = 2, 128, 128, 4
    x = (0.5 * rng.normal(size=(B, L, F))).astype(np.float32)
    valid = _valid(B, L, [L, 70])
    jm = JMHA(embed_dim=F, num_heads=H, impl=jimpl)
    params = _randomize(_np_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]), 4)
    want = jm.apply({"params": params}, jnp.asarray(x), q_valid=jnp.asarray(valid))
    sd = {}
    for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
        convert._linear(sd, params[name], name)
    tm = _load(MultiheadAttention(F, H, impl=impl), sd)
    with torch.no_grad():
        got = tm(_t(x), q_valid=_t(valid))
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], atol=5e-5, rtol=0)


def test_multihead_attention_unported_features_raise():
    """Edge features (bias E, gate G, edge updates), an additive attention
    bias and an adjacency mask, once refused here, are ported: each alone
    and all together equal the JAX module (its general path); impl='xla'
    stays refused."""
    rng = np.random.default_rng(7)
    B, L, F, H, E = 2, 6, 32, 2, 4
    x = rng.normal(size=(B, L, F)).astype(np.float32)
    edges = rng.normal(size=(B, L, L, E)).astype(np.float32)
    bias = rng.normal(size=(B, L, L, H)).astype(np.float32)
    adj = (rng.uniform(size=(B, L, L)) < 0.6) | np.eye(L, dtype=bool)[None]
    valid = _valid(B, L, [L, 4])
    jm = JMHA(embed_dim=F, num_heads=H, edge_embed_dim=E, update_edges=True, impl="xla")
    params = _randomize(_np_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), edges=jnp.asarray(edges),
                                         q_valid=jnp.asarray(valid))["params"]), 8)
    sd = {}
    for name in ("linear_q", "linear_k", "linear_v", "linear_out", "linear_e", "linear_g", "linear_e_out"):
        convert._linear(sd, params[name], name)
    tm = _load(MultiheadAttention(F, H, edge_embed_dim=E, update_edges=True), sd)
    for kw in ({"edges": edges}, {"attn_bias": bias}, {"attn_valid": adj},
               {"edges": edges, "attn_bias": bias, "attn_valid": adj}):
        want = jm.apply({"params": params}, jnp.asarray(x), q_valid=jnp.asarray(valid),
                        **{k: jnp.asarray(v) for k, v in kw.items()})
        with torch.no_grad():
            got = tm(_t(x), q_valid=_t(valid), **{k: _t(v) for k, v in kw.items()})
        if "edges" in kw:
            (got, got_e), (want, want_e) = got, want
            assert got_e.shape == (B, L, L, E)
            np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), atol=1e-5, rtol=0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    with pytest.raises(ValueError):
        MultiheadAttention(32, 2, impl="xla")
    tm = MultiheadAttention(32, 2)
    # cross-attention is ported: Lq = 4 queries over 40 keys with both masks
    # (the dense path, as the JAX package takes it) equals the JAX module
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 4, 32)).astype(np.float32)
    k = rng.normal(size=(2, 40, 32)).astype(np.float32)
    q_valid, kv_valid = _valid(2, 4, [3, 1]), _valid(2, 40, [40, 17])
    jm = JMHA(embed_dim=32, num_heads=2, impl="xla")
    jkw = dict(k=jnp.asarray(k), q_valid=jnp.asarray(q_valid), kv_valid=jnp.asarray(kv_valid))
    params = _randomize(_np_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(q), **jkw)["params"]), 6)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(q), **jkw))
    sd = {}
    for name in ("linear_q", "linear_k", "linear_v", "linear_out"):
        convert._linear(sd, params[name], name)
    tc = _load(MultiheadAttention(32, 2), sd)
    with torch.no_grad():
        got = tc(_t(q), k=_t(k), q_valid=_t(q_valid), kv_valid=_t(kv_valid))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # segment ids are ported: two segments of a row attend as two separate rows
    xr = torch.from_numpy(np.random.default_rng(1).normal(size=(1, 4, 32)).astype(np.float32))
    with torch.no_grad():
        got = tm(xr, segment_ids=torch.tensor([[0, 0, 1, 1]], dtype=torch.int32))
        want = torch.cat([tm(xr[:, :2]), tm(xr[:, 2:])], dim=1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("attn_impl", ["flash", "flash_nomax"])
def test_dit_layer_fused_unfused_and_jax_agree(attn_impl):
    """The fused path (folded eff_a/eff_b, Q pre-scale folded into weight and
    bias, one-pass MLP) and the unfused path are the same function, and both
    match the JAX layer with its fused Pallas path in interpret mode."""
    rng = np.random.default_rng(5)
    B, L, F, H, C = 2, 128, 128, 4, 24
    x = (0.5 * rng.normal(size=(B, L, F))).astype(np.float32)
    ctx = rng.normal(size=(B, C)).astype(np.float32)
    valid = _valid(B, L, [L, 33])
    jkw = dict(embed_dim=F, num_heads=H, dense_config=DENSE_CFG, attn_impl=attn_impl)
    jm = JDiTLayer(**jkw)
    params = _randomize(
        _np_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), q_valid=jnp.asarray(valid), context=jnp.asarray(ctx))["params"]), 6)
    want_fused = JDiTLayer(fused_prologue=True, **jkw).apply(
        {"params": params}, jnp.asarray(x), q_valid=jnp.asarray(valid), context=jnp.asarray(ctx))
    want_unfused = jm.apply({"params": params}, jnp.asarray(x), q_valid=jnp.asarray(valid), context=jnp.asarray(ctx))
    sd = _dit_layer_sd(params)
    outs = {}
    for fused in (False, True):
        tm = _load(DiTLayer(F, H, C, DENSE_CFG, attn_impl=attn_impl, fused_prologue=fused), sd)
        with torch.no_grad():
            outs[fused] = tm(_t(x), q_valid=_t(valid), context=_t(ctx)).numpy()
    np.testing.assert_allclose(outs[True][valid], outs[False][valid], atol=5e-5, rtol=0)
    np.testing.assert_allclose(outs[True][valid], np.asarray(want_fused)[valid], atol=5e-5, rtol=0)
    np.testing.assert_allclose(outs[False][valid], np.asarray(want_unfused)[valid], atol=5e-5, rtol=0)


def test_dit_encoder_small_shapes_take_the_unfused_branch():
    """L=48 fails the kernel gates: fused_prologue then computes the unfused
    formulation, like the JAX package, and matches it."""
    rng = np.random.default_rng(7)
    B, L, F, H, C = 2, 48, 128, 4, 16
    x = (0.5 * rng.normal(size=(B, L, F))).astype(np.float32)
    ctx = rng.normal(size=(B, C)).astype(np.float32)
    valid = _valid(B, L, [L, 20])
    jm = JDiTEncoder(embed_dim=F, num_layers=2, num_heads=H, dense_config=DENSE_CFG, attn_impl="flash_nomax",
                     fused_prologue=True)
    params = _randomize(
        _np_tree(jm.init(jax.random.PRNGKey(0), jnp.asarray(x), q_valid=jnp.asarray(valid), context=jnp.asarray(ctx))["params"]), 8)
    want = jm.apply({"params": params}, jnp.asarray(x), q_valid=jnp.asarray(valid), context=jnp.asarray(ctx))
    sd = {}
    for i in range(2):
        sd.update(_dit_layer_sd(params[f"layers_{i}"], f"layers.{i}."))
    convert._layernorm(sd, params["final_norm"], "final_norm")
    tm = _load(DiTEncoder(F, 2, H, C, DENSE_CFG, attn_impl="flash_nomax", fused_prologue=True), sd)
    with torch.no_grad():
        got = tm(_t(x), q_valid=_t(valid), context=_t(ctx))
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid], atol=5e-5, rtol=0)


def _golden():
    z = np.load(GOLDEN)
    cfg = yaml.safe_load(bytes(z["config"]).decode())
    tree = convert.unflatten({k.split("::", 1)[1]: z[k] for k in z.files if k.startswith("param::")})
    batch = {k.split("::", 1)[1]: _t(z[k]) for k in z.files if k.startswith("batch::")}
    return z, cfg, tree, batch


def test_params_from_jax_equals_export_flow_params():
    _, cfg, tree, _ = _golden()
    got = convert.params_from_jax(tree, cfg)
    want = export_flow_params(tree, cfg)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32 and np.array_equal(got[k].numpy(), want[k]), k
    assert "net.transformer.layers.0.adaLN_modulation.1.weight" in got
    assert got["net.transformer.layers.0.mha.linear_q.weight"].shape == (128, 128)


@pytest.mark.parametrize("attn_impl,fused", [("einsum", False), ("auto", False), ("flash", True), ("flash_nomax", True)])
def test_flow_model_matches_golden(attn_impl, fused):
    z, cfg, tree, batch = _golden()
    model = FlowModel(cfg, attn_impl=attn_impl, fused_prologue=fused).eval()
    res = model.load_reference_state_dict(convert.params_from_jax(tree, cfg))
    assert not res.missing_keys and not res.unexpected_keys
    with torch.no_grad():
        vt = model(batch, _t(z["noisy"]), _t(z["t"]))
    mask = z["batch::q_mask"]
    np.testing.assert_allclose(vt.numpy()[mask], z["vt"][mask], atol=1e-4, rtol=0)


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = tuple(np.shape(v))
    return out


def test_init_params_jax_layout_has_the_jax_models_tree():
    """The seeded initialiser used where no checkpoint exists builds exactly
    the tree (names and shapes) of the JAX FlowModel's parameters, which the
    golden file holds for its config."""
    _, cfg, golden_tree, _ = _golden()
    tree = convert.init_params_jax_layout(cfg, seed=3)
    assert _shapes(tree) == _shapes(golden_tree)
    again = convert.init_params_jax_layout(cfg, seed=3)
    ada = tree["transformer"]["layers_0"]["adaLN_modulation"]["kernel"]
    assert np.array_equal(ada, again["transformer"]["layers_0"]["adaLN_modulation"]["kernel"])
    bound = np.sqrt(6.0 / sum(ada.shape))
    assert 0.9 * bound < np.abs(ada).max() <= bound  # Xavier-uniform, gates not zero


def test_cast_params_for_inference_keeps_geometry_embedder_fp32():
    _, cfg, tree, batch = _golden()
    model = FlowModel(cfg).eval()
    model.load_reference_state_dict(convert.params_from_jax(tree, cfg))
    cast_params_for_inference(model)
    for name, p in model.named_parameters():
        want = torch.float32 if name.startswith("etaphi_emb_net.") else torch.bfloat16
        assert p.dtype == want, name
    sd = cast_params_for_inference(convert.params_from_jax(tree, cfg))
    assert sd["net.etaphi_emb_net.net.1.weight"].dtype == torch.float32
    assert sd["net.feat_0_mlp.net.0.weight"].dtype == torch.bfloat16
    # bf16 compute: held against the fp32 golden beside the JAX package's own
    # bf16 model on the same cast weights.  With these random weights bf16
    # rounding alone moves v_t by several 1e-2 in either package (JAX: 6.5e-2
    # max here), so the port must come as close to the golden as JAX does
    # (25% slack for another order of roundings), not closer to JAX than
    # JAX is to the truth.
    from superresolutionhep_tpu.models.flow_model import FlowModel as JFlowModel
    from superresolutionhep_tpu.models.precision import cast_params_for_inference as jcast

    z = np.load(GOLDEN)
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jvt = jax.jit(JFlowModel(config=cfg, dtype=jnp.bfloat16, attn_impl="xla").apply)(
        {"params": jcast(tree)}, jb, jnp.asarray(z["noisy"]), jnp.asarray(z["t"]))
    with torch.no_grad():
        vt = model(batch, _t(z["noisy"]), _t(z["t"]))
    mask = z["batch::q_mask"]
    assert vt.dtype == torch.bfloat16 and jvt.dtype == jnp.bfloat16
    err_port = np.abs(vt.float().numpy() - z["vt"])[mask]
    err_jax = np.abs(np.asarray(jvt.astype(jnp.float32)) - z["vt"])[mask]
    assert err_port.max() <= 1.25 * err_jax.max() and err_port.mean() <= 1.25 * err_jax.mean()
    assert err_port.max() < 0.1
