"""PyTorch port, the shipped trained checkpoints against the JAX package (fp32,
CPU): the Flax msgpack reader against ``flax.serialization.msgpack_restore``,
the Fourier geometry features, the ``closure_sr`` forward and its frozen ab2
golden, ``closure_pf`` loaded strictly, and the noise fixture that the port's
card-side checks read instead of drawing with JAX.

The fixture ``tests/golden_torch/sr_golden_x0.npz`` holds, for each SR
golden, the x0 that the JAX sampler draws (``flow/sampling.py``:
``jax.random.normal(PRNGKey(key_seed), e_proxy.shape)``), the key seed and the
SHA-256 of the golden file.  Write it anew with

    JAX_PLATFORMS=cpu python tests/test_torch_port_trained.py

and measure, on the CPU, how far this checkpoint's goldens can be reproduced
at all (the JAX package's own dopri5 run eagerly, its bf16 path, the no-max
clip against the attention logits; about 10 minutes) with

    JAX_PLATFORMS=cpu python tests/test_torch_port_trained.py gaps

Tolerances: the goldens' own (``tests/test_golden_sr_trained.py``: samples
within rtol = atol = 2e-3, the sigmoid share within 5e-4); a model evaluation
against the JAX model within 2e-3 of the output's max: the trained model is
ill-conditioned in fp32 (its fifth DiT layer turns relative rounding of 1e-6
into 1e-3; the port in fp32 against itself in fp64 differs by as much).  The
dopri5 golden runs on the card only (``chip_smoke.py``'s ``trained`` phase):
on one CPU core it takes about a minute.
"""

import hashlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from superresolutionhep_tpu.models.flow_model import FlowModel as JFlowModel  # noqa: E402
from superresolutionhep_tpu.models.pf.model_pf import SAPF as JSAPF  # noqa: E402
from superresolutionhep_tpu.train.checkpoint import load_params as jload_params  # noqa: E402
from superresolutionhep_tpu.transforms import build_var_transforms as jbuild_var_transforms  # noqa: E402
from superresolutionhep_tpu_torch.configs import (  # noqa: E402
    CLOSURE_SR_CONFIG_MV, CLOSURE_SR_CONFIG_T, MULTIPART_CONFIG_MV, PF_CONFIG_MV, PF_CONFIG_T,
)
from superresolutionhep_tpu_torch.flow.sampling import generate_samples  # noqa: E402
from superresolutionhep_tpu_torch.inference.pf import PFInference  # noqa: E402
from superresolutionhep_tpu_torch.inference.sr import SRInference  # noqa: E402
from superresolutionhep_tpu_torch.models.flow_model import FlowModel  # noqa: E402
from superresolutionhep_tpu_torch.tools import convert  # noqa: E402
from superresolutionhep_tpu_torch.train import msgpack_io  # noqa: E402
from superresolutionhep_tpu_torch.train.checkpoint import (  # noqa: E402
    is_jax_tree, load_params, load_reference_params,
)

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR_CKPT = os.path.join(ROOT, "saved_checkpoints", "closure_sr")
PF_CKPT = os.path.join(ROOT, "saved_checkpoints", "closure_pf")
GOLDENS = ("sr_trained_golden", "sr_tpu_golden")
FIXTURE = os.path.join(ROOT, "tests", "golden_torch", "sr_golden_x0.npz")
MODEL_KEYS = ("eta", "cosphi", "sinphi", "layer", "e_proxy", "q_mask")


def _golden(name):
    path = os.path.join(ROOT, "tests", "golden", f"{name}.npz")
    return path, np.load(path)


def fixture_arrays() -> dict:
    """The fixture's content, drawn with JAX: per golden its x0, key seed and
    the SHA-256 of the golden file."""
    out = {}
    for name in GOLDENS:
        path, z = _golden(name)
        e_proxy = z["batch::e_proxy"]
        seed = int(z["key_seed"])
        out[f"x0::{name}"] = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), e_proxy.shape, e_proxy.dtype))
        out[f"key_seed::{name}"] = np.int64(seed)
        out[f"golden_sha256::{name}"] = np.frombuffer(hashlib.sha256(open(path, "rb").read()).digest(), np.uint8)
    return out


def write_fixture(path=FIXTURE):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **fixture_arrays())
    return path


def _tb(batch, keys=MODEL_KEYS):
    return {k: torch.from_numpy(np.ascontiguousarray(batch[k])) for k in keys}


def test_x0_fixture_is_the_jax_draw(tmp_path):
    """The committed fixture equals the JAX draws bit for bit, names the
    goldens' current bytes, and is what ``write_fixture`` (the module's
    ``__main__``) writes."""
    z = np.load(FIXTURE)
    want = fixture_arrays()
    assert sorted(z.files) == sorted(want)
    for k, v in want.items():
        assert z[k].dtype == v.dtype and np.array_equal(z[k], v), k
    fresh = np.load(write_fixture(str(tmp_path / "x0.npz")))
    for k in want:
        assert np.array_equal(fresh[k], z[k]), k


def test_msgpack_reader_equals_flax():
    """Leaf for leaf (same paths, dtypes, shapes, values) against Flax's own
    reader on both shipped checkpoints and on a tree with fp32, bf16, int
    and numpy-scalar leaves; ``load_params`` wraps the tree as the JAX
    package does; the config literals are the checkpoints' YAML files."""
    from flax.serialization import msgpack_restore, msgpack_serialize

    def same(a, b, path=()):
        if isinstance(b, dict):
            assert isinstance(a, dict) and sorted(a) == sorted(b), path
            for k in b:
                same(a[k], b[k], path + (k,))
        elif isinstance(b, list):
            assert isinstance(a, list) and len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, path + (i,))
        elif isinstance(b, (np.ndarray, np.generic)) and b.dtype == jnp.bfloat16:
            assert a.dtype == torch.bfloat16 and tuple(a.shape) == b.shape, path
            assert np.array_equal(a.view(torch.int16).numpy(), np.asarray(b).view(np.int16)), path
        elif isinstance(b, (np.ndarray, np.generic)):
            assert type(a) is type(b) and a.dtype == b.dtype and a.shape == b.shape, path
            assert np.array_equal(a, b), path
        else:
            assert type(a) is type(b) and a == b, path

    for ckpt in (SR_CKPT, PF_CKPT):
        blob = open(os.path.join(ckpt, "params.msgpack"), "rb").read()
        same(msgpack_io.msgpack_restore(blob), msgpack_restore(blob))
        mine = load_params(os.path.join(ckpt, "params.msgpack"))
        assert is_jax_tree(mine) and sorted(mine) == sorted(jload_params(os.path.join(ckpt, "params.msgpack")))
    rng = np.random.default_rng(0)
    tree = {"f32": rng.normal(size=(3, 5)).astype(np.float32),
            "bf16": jnp.asarray(rng.normal(size=(2, 7)), jnp.bfloat16),
            "nested": {"i32": np.arange(-70000, 70000, 9999, dtype=np.int32), "u8": np.arange(4, dtype=np.uint8),
                       "f64": np.float64(-2.5), "i64": np.int64(-(2 ** 40)), "f32s": np.float32(3.25)},
            "plain": [1, -3, 200, -200, 70000, 2 ** 40, 1.5, None, True, False, "x" * 40, b"\x00\x01"], "empty": {}}
    blob = msgpack_serialize(tree)
    same(msgpack_io.msgpack_restore(blob), msgpack_restore(blob))
    with pytest.raises(ValueError, match="complex"):
        msgpack_io.msgpack_restore(msgpack_serialize({"c": 1 + 2j}))
    assert CLOSURE_SR_CONFIG_MV == yaml.safe_load(open(os.path.join(SR_CKPT, "model_and_var.yml")))
    assert CLOSURE_SR_CONFIG_T == yaml.safe_load(open(os.path.join(SR_CKPT, "train.yml")))
    assert PF_CONFIG_MV == yaml.safe_load(open(os.path.join(PF_CKPT, "model_and_var.yml")))


def test_fourier_flow_model_matches_jax():
    """A small FlowModel with 3 Fourier octaves (h 64, 1 DiT layer) against
    the JAX model on the same weights; the converter maps the wider first
    geometry layer and ``init_params_jax_layout`` has the JAX tree's shapes."""
    cfg = dict(MULTIPART_CONFIG_MV["flow_model"], h_dim=64)
    cfg["etaphi_emb"] = dict(cfg["etaphi_emb"], fourier_features=3)
    cfg["feat_0_mlp"] = dict(cfg["feat_0_mlp"], output_size=64)
    cfg["transformer"] = dict(cfg["transformer"], num_transformer_layers=1,
                              dense_config=dict(cfg["transformer"]["dense_config"], hidden_layers=[64]))
    rng = np.random.default_rng(4)
    B, N = 2, 24
    phi = rng.uniform(-3, 3, size=(B, N, 1)).astype(np.float32)
    batch = {"eta": rng.uniform(-1, 1, size=(B, N, 1)).astype(np.float32), "cosphi": np.cos(phi),
             "sinphi": np.sin(phi), "layer": rng.integers(0, 3, size=(B, N, 1)).astype(np.int32),
             "e_proxy": rng.normal(size=(B, N, 1)).astype(np.float32),
             "q_mask": np.arange(N)[None, :] < np.array([[N], [15]])}
    x = rng.normal(size=(B, N, 1)).astype(np.float32)
    t = np.array([0.2, 0.9], np.float32)
    params = convert.init_params_jax_layout(cfg, seed=3)
    jm = JFlowModel(config=cfg, attn_impl="einsum")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jb, jnp.asarray(x), jnp.asarray(t))["params"]
    assert jax.tree_util.tree_map(lambda a: a.shape, shapes) == jax.tree_util.tree_map(np.shape, params)
    assert params["etaphi_emb_net"]["linear_0"]["kernel"].shape == (3 + 12 + 64, 64)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jb, jnp.asarray(x), jnp.asarray(t)))
    model = FlowModel(cfg)
    model.load_reference_state_dict(convert.params_from_jax(params, cfg))
    with torch.no_grad():
        got = model.eval()(_tb(batch), torch.from_numpy(x), torch.from_numpy(t)).numpy()
    m = batch["q_mask"]
    np.testing.assert_allclose(got[m], want[m], rtol=0, atol=1e-5)


def test_closure_sr_forward_matches_jax():
    """``SRInference`` loads ``closure_sr`` from its msgpack blob (the
    normal entry point, ``model.checkpoint_path``); one evaluation of its
    model on 256 cells of the golden's first event against the JAX model
    with ``attn_impl="einsum"`` on the JAX package's own reader's tree."""
    inf = SRInference({"model": {"config_mv": CLOSURE_SR_CONFIG_MV, "config_t": CLOSURE_SR_CONFIG_T,
                                 "checkpoint_path": os.path.join(SR_CKPT, "params.msgpack"), "n_steps": 25}},
                      device="cpu")
    _, z = _golden("sr_trained_golden")
    batch = {k: z[f"batch::{k}"][:1, :256] for k in MODEL_KEYS}
    rng = np.random.default_rng(5)
    x = rng.normal(size=batch["e_proxy"].shape).astype(np.float32)
    t = np.array([0.37], np.float32)
    jm = JFlowModel(config=CLOSURE_SR_CONFIG_MV["flow_model"], attn_impl="einsum")
    want = np.asarray(jax.jit(jm.apply)(jload_params(os.path.join(SR_CKPT, "params.msgpack")),
                               {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = inf.model(_tb(batch), torch.from_numpy(x), torch.from_numpy(t)).numpy()
    m = batch["q_mask"]
    assert np.abs(got[m] - want[m]).max() <= 2e-3 * np.abs(want[m]).max()


def test_closure_sr_ab2_matches_frozen_golden():
    """The port's fp32 ab2 on the shipped weights, from the fixture's x0,
    against ``sr_trained_golden.npz`` ``expected::ab2`` at the golden's own
    tolerances, on the golden's first event (the model treats the rows of a
    batch independently; the card runs both, ``chip_smoke.py``)."""
    _, z = _golden("sr_trained_golden")
    x0 = np.load(FIXTURE)["x0::sr_trained_golden"][:1]
    model = FlowModel(CLOSURE_SR_CONFIG_MV["flow_model"])
    model.load_reference_state_dict(load_reference_params(os.path.join(SR_CKPT, "params.msgpack"),
                                                          CLOSURE_SR_CONFIG_MV["flow_model"]))
    model.eval()
    batch = _tb({k: z[f"batch::{k}"][:1] for k in MODEL_KEYS})
    out = generate_samples(lambda b, x, t: model(b, x, t), batch, n_steps=int(z["n_steps"]), method="ab2",
                           x0=torch.from_numpy(x0))
    m = z["batch::q_mask"][:1]
    got, want = out.numpy()[..., 0][m], z["expected::ab2"][:1, ..., 0][m]
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(1.0 / (1.0 + np.exp(-got)), 1.0 / (1.0 + np.exp(-want)), atol=5e-4)


def test_closure_pf_loads_strict_and_matches_jax():
    """``PFInference`` loads ``closure_pf`` from its msgpack blob (strict
    ``load_state_dict``: every key of the model, no other); its SAPF forward
    against the JAX SAPF on the same tree, fp32."""
    from test_torch_port_pf_model import make_pf_batch

    inf = PFInference({"model": {"config_mv": PF_CONFIG_MV, "config_t": PF_CONFIG_T,
                                 "checkpoint_path": os.path.join(PF_CKPT, "params.msgpack")}}, device="cpu")
    sd = load_reference_params(os.path.join(PF_CKPT, "params.msgpack"), PF_CONFIG_MV["pf_model"], "pf")
    assert sd.keys() == convert.pf_params_from_jax(load_params(os.path.join(PF_CKPT, "params.msgpack")),
                                                   PF_CONFIG_MV["pf_model"]).keys()
    res = inf.model.load_reference_state_dict(sd, strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    batch = make_pf_batch(21)
    jm = JSAPF(config_pf=PF_CONFIG_MV["pf_model"], transforms=jbuild_var_transforms(PF_CONFIG_MV["var_transform"]),
               inference=True, attn_impl="xla")
    want = jax.jit(jm.apply)(jload_params(os.path.join(PF_CKPT, "params.msgpack")),
                             {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.no_grad():
        got = inf.model({k: torch.from_numpy(v) for k, v in batch.items()})
    for name, g, w in zip(("logits", "kin", "inc"), got, want):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * max(np.abs(w).max(), 1.0), name


def measure_gaps() -> dict:
    """How reproducible the two SR goldens are on this checkpoint, measured
    on the CPU with the JAX package and with the port (fp32 unless named):
      * ``dopri5``: the JAX solver and model under ``jax.disable_jit`` (the
        same arithmetic, run op by op) and the port against
        ``expected::dopri5``: the adaptive steps turn one-ulp differences of
        the first step size into differences of the samples far above 2e-3;
      * ``logits``: the largest base-2 attention logit of each DiT layer at
        t = 0 on ``sr_tpu_golden``'s batch, beside the no-max clip (80);
      * ``ab2e`` on ``sr_tpu_golden``'s batch, max and 99th percentile of
        |diff| on valid cells: the JAX package's bf16 einsum path and the
        port's bf16 paths against the fp32 ones, the port's bf16 paths
        against the JAX package's (einsum against einsum, the robust flash
        path against einsum, the no-max fused path against the JAX no-max
        fused path with its Pallas kernels in interpret mode), the no-max
        function against the robust one, and each against the golden frozen
        on a TPU."""
    from superresolutionhep_tpu.flow import ode as jode
    from superresolutionhep_tpu_torch.flow import ode as tode
    from superresolutionhep_tpu_torch.models.precision import cast_params_for_inference

    fm = CLOSURE_SR_CONFIG_MV["flow_model"]
    jparams = jload_params(os.path.join(SR_CKPT, "params.msgpack"))
    sd = convert.params_from_jax(load_params(os.path.join(SR_CKPT, "params.msgpack")), fm)
    x0s = np.load(FIXTURE)
    out = {}

    _, z = _golden("sr_trained_golden")
    m = z["batch::q_mask"]
    x0 = x0s["x0::sr_trained_golden"]
    jm = JFlowModel(config=fm, attn_impl="einsum")
    jb = {k: jnp.asarray(z[f"batch::{k}"]) for k in MODEL_KEYS}
    japply = jax.jit(lambda x, t: jm.apply(jparams, jb, x, jnp.full((x.shape[0],), t, x.dtype)))
    ts = np.linspace(0.0, 1.0, int(z["n_steps"])).astype(np.float32)
    with jax.disable_jit():
        eager = np.asarray(jode.odeint_dopri5(lambda t, y: japply(y, t), jnp.asarray(x0), jnp.asarray(ts)))[-1]
    model = FlowModel(fm)
    model.load_reference_state_dict(sd)
    model.eval()
    tb = _tb({k: z[f"batch::{k}"] for k in MODEL_KEYS})
    with torch.no_grad():
        port = tode.odeint_dopri5(lambda t, y: model(tb, y, t.expand(y.shape[0])), torch.from_numpy(x0),
                                  torch.from_numpy(ts))[-1].numpy()
    want = z["expected::dopri5"]
    out["dopri5_max_abs_diff_vs_golden"] = {"jax_eager": float(np.abs(eager - want)[m].max()),
                                            "port": float(np.abs(port - want)[m].max()), "tol": 2e-3}

    _, z = _golden("sr_tpu_golden")
    m = z["batch::q_mask"]
    x0 = torch.from_numpy(x0s["x0::sr_tpu_golden"])
    tb = _tb({k: z[f"batch::{k}"] for k in MODEL_KEYS})
    caps = {}
    hooks = [mod.register_forward_hook(lambda _m, _a, o, key=(n, i): caps.__setitem__(key, o))
             for i, layer in enumerate(model.transformer.layers)
             for n, mod in (("q", layer.mha.linear_q), ("k", layer.mha.linear_k))]
    with torch.no_grad():
        model(tb, x0, torch.zeros(x0.shape[0]))
    for h in hooks:
        h.remove()
    pair = torch.from_numpy(m)[:, None, :, None] & torch.from_numpy(m)[:, None, None, :]
    B, N = m.shape
    logit_max = []
    for i in range(len(model.transformer.layers)):
        q, k = (caps[(n, i)].reshape(B, N, 4, 64) for n in ("q", "k"))
        s2 = torch.einsum("bqhd,bkhd->bhqk", q, k) / 8.0 * 1.4426950408889634
        logit_max.append(float(s2.masked_fill(~pair, -1e30).max()))
    out["base2_logit_max_by_layer_t0"] = logit_max
    out["nomax_clip_hi"] = 80.0

    def port_ab2e(impl, dtype, fused):
        mm = FlowModel(fm, attn_impl=impl, fused_prologue=fused)
        mm.load_reference_state_dict(sd)
        mm.eval()
        if dtype is not None:
            cast_params_for_inference(mm, dtype)
        with torch.no_grad():
            return generate_samples(lambda b, x, t: mm(b, x, t), tb, n_steps=25, method="ab2e",
                                    x0=x0)[..., 0].float().numpy()[m]

    def jax_ab2e(dtype, impl="einsum", fused=False):
        from superresolutionhep_tpu.flow.sampling import generate_samples as jgen
        from superresolutionhep_tpu.models.precision import cast_params_for_inference as jcast

        jmm = JFlowModel(config=fm, attn_impl=impl, dtype=dtype, fused_prologue=fused)
        v = jcast(jparams) if dtype is not None else jparams
        b = {k: jnp.asarray(z[f"batch::{k}"]) for k in MODEL_KEYS}
        fn = jax.jit(lambda v, b: jgen(lambda vv, bb, x, t: jmm.apply(vv, bb, x, t), v, b,
                                       jax.random.PRNGKey(int(z["key_seed"])), n_steps=25, method="ab2e"))
        return np.asarray(fn(v, b), np.float32)[..., 0][m]

    runs = {"jax_fp32": jax_ab2e(None), "jax_bf16": jax_ab2e(jnp.bfloat16),
            "jax_bf16_nomax_fused": jax_ab2e(jnp.bfloat16, "flash_nomax", True),
            "port_fp32": port_ab2e("flash", None, False), "port_fp32_nomax": port_ab2e("flash_nomax", None, False),
            "port_bf16": port_ab2e("flash", torch.bfloat16, False),
            "port_bf16_einsum": port_ab2e("einsum", torch.bfloat16, False),
            "port_bf16_nomax_fused": port_ab2e("flash_nomax", torch.bfloat16, True)}
    tpu = z["expected"][..., 0][m]
    pairs = (("jax_bf16", "jax_fp32"), ("port_fp32", "jax_fp32"), ("port_bf16", "port_fp32"),
             ("port_bf16_einsum", "jax_bf16"), ("port_bf16", "jax_bf16"),
             ("port_bf16_nomax_fused", "jax_bf16_nomax_fused"),
             ("port_fp32_nomax", "port_fp32"), ("port_bf16_nomax_fused", "port_fp32"),
             ("port_bf16_nomax_fused", "port_fp32_nomax"))

    def dist(a, b):
        d = np.abs(a - b)
        return {"max": float(d.max()), "p99": float(np.percentile(d, 99))}

    out["ab2e_abs_diff"] = {f"{a}_vs_{b}": dist(runs[a], runs[b]) for a, b in pairs}
    out["ab2e_abs_diff_vs_tpu_golden"] = {k: dist(v, tpu) for k, v in runs.items()}
    out["ab2e_tol"] = 3e-2
    return out


if __name__ == "__main__":
    if sys.argv[1:] == ["gaps"]:
        import json

        torch.set_num_threads(os.cpu_count() or 1)
        print(json.dumps(measure_gaps()))
    else:
        print(write_fixture())
