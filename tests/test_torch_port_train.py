"""PyTorch port, SR training against the JAX package on the same numpy
inputs, the same weights and the same noise (CPU): one train step of
``SRTrainer`` (loss, every gradient, the parameters after the AdamW update)
in fp32 and in bf16 compute, the fused-prologue step with the flash
attention Function, the learning-rate schedule, the init policies and the
parameter converter in both directions.  The data pipeline and the training
loop are in test_torch_port_train_data.py and test_torch_port_train_loop.py.

The noise and the flow times are drawn with ``jax.random`` exactly as the
JAX package's ``sample_location_and_conditional_flow`` draws them and handed
to the port's ``train_step``.  Tolerances: fp32 loss 1e-5 relative, each
gradient 1e-4 of its own max, parameters after the update 1e-6 absolute
(another summation order, fp32 on both sides); bf16 compute 3e-2 (the bound
the JAX package's bf16 goldens are held to)."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolutionhep_tpu.models.flow_model import FlowModel as JFlowModel
from superresolutionhep_tpu.models.init_policies import apply_init_policies as japply_init_policies
from superresolutionhep_tpu.tools.torch_export import export_flow_params
from superresolutionhep_tpu.train.schedule import schedule_from_config as jschedule_from_config
from superresolutionhep_tpu.train.sr_trainer import SRTrainer as JSRTrainer
from superresolutionhep_tpu.train.sr_trainer import _dummy_batch as _jax_dummy_batch
from superresolutionhep_tpu_torch.data.sr_dataset import MODEL_BATCH_KEYS, SupResEvents, collate
from superresolutionhep_tpu_torch.data.synthetic import GeneratorConfig, generate_events
from superresolutionhep_tpu_torch.models.flow_model import FlowModel
from superresolutionhep_tpu_torch.models.init_policies import apply_init_policies
from superresolutionhep_tpu_torch.tools.convert import params_from_jax, params_to_jax
from superresolutionhep_tpu_torch.train.schedule import schedule_from_config
from superresolutionhep_tpu_torch.train.sr_trainer import SRTrainer

from test_flow_model import small_flow_config

torch.set_num_threads(1)


def make_configs(flow_cfg=None, **train_overrides):
    config_mv = {
        "graph_building": "all2all",
        "res_factor": 2,
        "flow_model": flow_cfg or small_flow_config("DiT"),
        "var_transform": {
            "eta": {"transformation": None, "scale_mode": "min_max", "min": -2.988, "max": 2.988, "range": [-1, 1]},
            "e": {"transformation": "pow(x,m)", "m": 0.2, "scale_mode": "standard"},
        },
        "target_transform": {
            "transformation": "logit_ratio", "f": 1.2, "alpha": 1.0e-6,
            "scale_mode": "standard", "mean": -1.1424768, "std": 3.616942,
        },
    }
    config_t = {
        "num_epochs": 2, "eval_every_n_epoch": 1, "batch_size_train": 4, "batch_size_val": 4,
        "bucket_quantum": 64, "learningrate": 1.0e-3,
        "lr_scheduler": {"name": "CustomLRScheduler", "warm_start_epochs": 1, "cosine_epochs": 1,
                         "eta_min": 1.0e-5, "last_epoch": -1, "max_epochs": "take_as_num_epochs"},
        "val_ode_method": "dopri5", "n_event_displays": 0, "num_workers": 0,
    }
    config_t.update(train_overrides)
    return config_mv, config_t


def make_dataset(config_mv, n, seed):
    trees = generate_events(n, seed=seed, config=GeneratorConfig(single_electron=True, window_lr_cells=1))
    return SupResEvents.from_trees(trees["Low_Tree"], trees["High_Tree"], config_mv)


def host_batch(config_mv, pad_n, n=3, seed=5):
    ds = make_dataset(config_mv, n, seed)
    hb = collate([ds.get_event(i) for i in range(n)] + [None], pad_n)  # one filler row
    return {k: hb[k] for k in MODEL_BATCH_KEYS}


def randomize(params, seed):
    """Every leaf plus seeded noise: the zero-init adaLN would otherwise gate
    the attention off and leave its gradients exactly zero."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.1 * rng.normal(size=a.shape)).astype(np.float32), params)


def jax_noise(key, target):
    """x0 and t exactly as the JAX package's cfm draws them."""
    k_noise, k_t = jax.random.split(key)
    x0 = jax.random.normal(k_noise, target.shape, target.dtype)
    t = jax.random.uniform(k_t, (target.shape[0],), target.dtype)
    return np.array(x0), np.array(t)


def _rel_close(got, want, tol, what, floor=0.0):
    """max |got - want| <= tol x max(max |want|, floor)."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    scale = max(float(np.abs(want).max()), floor, 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max err {err:.3g} > {tol} x {scale:.3g}"


def jax_trainer(config_mv, config_t, dtype=None, **model_kw):
    """The JAX package's SRTrainer with its model, optimizer and init policies
    but without its ``__init__``, whose eager ``FlowModel.init`` compiles every
    op on its own (~20 s on one core): the same key splits and policies, one
    jitted init.  Returns (trainer, params as numpy)."""
    jtr = JSRTrainer.__new__(JSRTrainer)
    jtr.config_mv, jtr.config_t = config_mv, config_t
    fm = config_mv["flow_model"]
    jtr.model = JFlowModel(config=fm, dtype=dtype, **model_kw)
    jtr.sigma_min = float(fm["sigma_min"])
    jtr.tx = jtr._make_optimizer()
    _, init_rng, pol_rng = jax.random.split(jax.random.PRNGKey(0), 3)
    variables = jax.jit(jtr.model.init)(init_rng, *_dummy_inputs())
    params = japply_init_policies(variables["params"], fm.get("init_weights", {}), pol_rng)
    jtr.fresh_init = (jax.tree_util.tree_map(np.asarray, variables["params"]), pol_rng)
    return jtr, jax.tree_util.tree_map(np.asarray, params)


def jax_step(jtr, params, hb, key, with_update=True):
    """The JAX side of one step: (loss, grads) from the trainer's own loss,
    and the parameters after its ``_train_step_impl``."""
    jb = {k: jnp.asarray(v) for k, v in hb.items()}
    (loss, _), grads = jax.jit(jax.value_and_grad(jtr._loss_fn, has_aux=True))(params, jb, key)
    new = None
    if with_update:
        new, _, _ = jax.jit(jtr._train_step_impl)(params, jtr.tx.init(params), jb, key, jnp.float32(1e-3))
    return float(loss), grads, new


def torch_step(tmp_path, config_mv, config_t, params, hb, key, dtype=None, attn="auto"):
    """The port's side: loss and grads of ``loss_and_grads``, then one
    ``train_step`` (lr 1e-3), on the JAX package's draws of t and x0."""
    fm = config_mv["flow_model"]
    ttr = SRTrainer(config_mv, config_t, run_dir=str(tmp_path), seed=0, dtype=dtype, device="cpu",
                    params=params_from_jax(params, fm), attn_impl=attn)
    tb = {k: torch.from_numpy(v) for k, v in hb.items()}
    x0, t = (torch.from_numpy(a) for a in jax_noise(key, hb["target"]))
    loss, _, grads = ttr.loss_and_grads(tb, t=t, x0=x0)
    names = [n for n, _ in ttr.model.named_parameters()]
    ttr.train_step(tb, t=t, x0=x0, lr=1e-3)
    return float(loss.detach()), dict(zip(names, grads)), ttr


def _ref_layout(tree, fm):
    return {k[4:]: v for k, v in params_from_jax(tree, fm).items()}


def _check_grads(tg, jg, tol):
    """Each gradient within ``tol`` of max(its own max, 1e-3 of the largest
    gradient): the floor covers the key biases, whose gradient is zero in
    exact arithmetic (softmax ignores a per-query shift) and rounding noise
    on both sides."""
    assert set(tg) == set(jg)
    top = max(float(g.abs().max()) for g in jg.values())
    for name in jg:
        _rel_close(tg[name].numpy(), jg[name].numpy(), tol, f"grad {name}", floor=1e-3 * top)
        assert float(jg[name].abs().max()) > 0.0, f"grad {name} is zero: the comparison would be vacuous"


@pytest.fixture(scope="module")
def fp32_step(tmp_path_factory):
    """Both packages' fp32 step on the small DiT config (einsum attention on
    both sides, as 'auto' picks on the CPU), from randomised parameters: the
    zero-init adaLN would otherwise gate the attention off and leave its
    gradients exactly zero."""
    config_mv, config_t = make_configs()
    jtr, fresh = jax_trainer(config_mv, config_t)
    params = randomize(fresh, 3)
    hb = host_batch(config_mv, 128)
    key = jax.random.PRNGKey(17)
    jloss, jgrads, jnew = jax_step(jtr, params, hb, key)
    tloss, tgrads, ttr = torch_step(tmp_path_factory.mktemp("fp32"), config_mv, config_t, params, hb, key)
    return dict(config_mv=config_mv, config_t=config_t, jtr=jtr, fresh=fresh, params=params, hb=hb, key=key,
                jloss=jloss, jgrads=jgrads, jnew=jnew, tloss=tloss, tgrads=tgrads, ttr=ttr,
                tmp=tmp_path_factory)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_train_step_matches_jax(fp32_step, precision):
    """fp32: loss 1e-5 relative, every gradient 1e-4 (``_check_grads``), the
    AdamW update given the same gradients within 1e-6, the whole step's
    parameters within 1e-6 wherever the gradient is above 1e-6 (Adam's first
    step is lr * g / (|g| + 1e-8): a gradient of rounding-noise size moves its
    parameter by up to +-lr in either package, whichever sign it rounds to).
    bf16 compute: loss within 3e-2; the gradients as close to the fp32
    gradients as the JAX package's own bf16 gradients are, to within 25%, and
    within 10% in L2 over all leaves.  A per-leaf 3e-2 bound between the two
    packages cannot hold: bf16 rounding moves the embedding nets' gradients
    by 5-10% of their max in the JAX package itself, and the two frameworks
    round at other places (XLA keeps fused elementwise chains in fp32)."""
    r = fp32_step
    fm = r["config_mv"]["flow_model"]
    jg32 = _ref_layout(r["jgrads"], fm)
    if precision == "fp32":
        assert np.isfinite(r["tloss"]) and abs(r["tloss"] - r["jloss"]) <= 1e-5 * abs(r["jloss"])
        _check_grads(r["tgrads"], jg32, 1e-4)
        jnew = _ref_layout(r["jnew"], fm)
        # the optimizer alone, fed the JAX gradients, from the same parameters
        opt_tr = SRTrainer(r["config_mv"], r["config_t"], run_dir=str(r["tmp"].mktemp("opt")), device="cpu",
                           params=params_from_jax(r["params"], fm))
        names = [n for n, _ in opt_tr.model.named_parameters()]
        opt_tr.opt.step([jg32[n] for n in names], 1e-3)
        for n, p in opt_tr.model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), jnew[n].numpy(), atol=1e-6, rtol=0, err_msg=n)
        for n, p in r["ttr"].model.named_parameters():
            live = jg32[n].abs() > 1e-6
            np.testing.assert_allclose(p.detach()[live].numpy(), jnew[n][live].numpy(), atol=1e-6, rtol=0,
                                       err_msg=n)
        return
    jtr16 = JSRTrainer.__new__(JSRTrainer)
    jtr16.__dict__.update(r["jtr"].__dict__)
    jtr16.model = JFlowModel(config=fm, dtype=jnp.bfloat16)
    jloss, jgrads, _ = jax_step(jtr16, r["params"], r["hb"], r["key"], with_update=False)
    tloss, tgrads, _ = torch_step(r["tmp"].mktemp("bf16"), r["config_mv"], r["config_t"], r["params"], r["hb"],
                                  r["key"], dtype=torch.bfloat16)
    assert np.isfinite(tloss) and abs(tloss - jloss) <= 3e-2 * abs(jloss)
    jg16 = _ref_layout(jgrads, fm)

    def dist(g):
        return float(np.sqrt(sum(float(((g[k].float() - jg32[k]) ** 2).sum()) for k in jg32)))

    norm = float(np.sqrt(sum(float((v ** 2).sum()) for v in jg32.values())))
    d_t, d_j = dist(tgrads), dist(jg16)
    assert d_t <= 1.25 * d_j and d_t <= 0.1 * norm, (d_t / norm, d_j / norm)


def test_fused_prologue_step_matches_jax(tmp_path):
    """``fused_prologue: true`` with the flash attention path on both sides
    (JAX: the Pallas kernels in interpret mode; port: the plain versions
    behind the same autograd Functions), at F = 128, L = 128 where the fused
    gates pass, fp32.  The Q/K/V weights reach the fused kernel only through
    the folded (F, 3F) weight, so their gradients prove that fold
    differentiable."""
    fm = small_flow_config("DiT")
    fm = dict(fm, h_dim=128, feat_0_mlp=dict(fm["feat_0_mlp"], output_size=128),
              transformer=dict(fm["transformer"], num_heads=2, num_transformer_layers=1,
                               dense_config=dict(fm["transformer"]["dense_config"], hidden_layers=[128])))
    config_mv, config_t = make_configs(fm, fused_prologue=True)
    jtr, params = jax_trainer(config_mv, config_t, attn_impl="flash", fused_prologue=True)
    params = randomize(params, 4)
    hb = host_batch(config_mv, 128, n=1)  # one event and one filler row: interpret mode is slow
    key = jax.random.PRNGKey(23)
    jloss, jgrads, _ = jax_step(jtr, params, hb, key, with_update=False)
    tloss, tgrads, ttr = torch_step(tmp_path, config_mv, config_t, params, hb, key, attn="flash")
    assert ttr.model.transformer.layers[0].fused_prologue
    assert abs(tloss - jloss) <= 1e-5 * abs(jloss)
    _check_grads(tgrads, _ref_layout(jgrads, fm), 1e-4)
    for w in ("linear_q", "linear_k", "linear_v"):
        assert float(tgrads[f"transformer.layers.0.mha.{w}.weight"].abs().max()) > 0.0


def test_schedule_values_equal():
    for sched in (
        None,
        {"warm_start_epochs": 0.05, "cosine_epochs": 0.8, "eta_min": 1e-5, "max_epochs": "take_as_num_epochs"},
        {"warm_start_epochs": 3, "cosine_epochs": 10, "eta_min": 0.0},
    ):
        ct = {"learningrate": 1e-3, "num_epochs": 100, "lr_scheduler": sched}
        j, t = jschedule_from_config(ct), schedule_from_config(ct)
        assert [t(e) for e in range(110)] == [j(e) for e in range(110)]




def test_init_policies_effects(fp32_step):
    """The same zeros as the JAX package's policies, N(0, 0.02) draws where
    it draws them, everything else untouched."""
    fm = small_flow_config("DiT")
    model = FlowModel(fm)
    before = model.state_dict()
    after = apply_init_policies(before, fm["init_weights"], torch.Generator().manual_seed(0))
    jbefore_tree, pol_rng = fp32_step["jtr"].fresh_init
    jafter = params_from_jax(japply_init_policies(jbefore_tree, fm["init_weights"], pol_rng), fm)
    jbefore = params_from_jax(jbefore_tree, fm)
    for k, v in after.items():
        jk = f"net.{k}"
        zero_t, zero_j = bool((v == 0).all()), bool((jafter[jk] == 0).all())
        if not k.endswith(".bias"):
            assert zero_t == zero_j, f"{k}: zeroed in one package only"
        changed_j = not torch.equal(jafter[jk], jbefore[jk])
        if k.startswith(("layer_emb_table", "time_step_embedder")) and k.endswith("weight"):
            assert changed_j and 0.0 < float(v.std()) < 0.05, k
        elif not changed_j:
            assert torch.equal(v, before[k]), f"{k}: changed by the port's policies only"


def _dummy_inputs():
    db = _jax_dummy_batch()
    return db, db["target"], jnp.zeros((2,))


def test_params_converter_both_ways(fp32_step):
    """A JAX SRTrainer's freshly initialised parameters (its init and init
    policies, ``jax_trainer``) load strictly into the port's FlowModel and
    map back to the same tree; the forward map equals the JAX package's own
    exporter."""
    fm = fp32_step["config_mv"]["flow_model"]
    jp = fp32_step["fresh"]
    sd = params_from_jax(jp, fm)
    ref = export_flow_params(jp, fm)
    assert set(sd) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(sd[k].numpy(), ref[k])
    model = FlowModel(fm)
    res = model.load_reference_state_dict(sd, strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    back = params_to_jax(model.state_dict(), fm)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_b)
    for path, leaf in flat_j:
        np.testing.assert_array_equal(flat_b[path], leaf)
