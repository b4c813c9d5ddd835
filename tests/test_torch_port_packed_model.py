"""PyTorch port, the segment-packed model path against the JAX package on the
same numpy inputs and weights (fp32, CPU).

  * ``pack_events`` / ``collate_packed`` give the JAX package's layouts and
    batches exactly, and ``segment_onehot`` / ``segment_mean`` its values;
  * the packed ``FlowModel`` forward, unfused (dense block-diagonal attention
    on both sides, as 'auto' picks on the CPU) and fused (the fused prologue
    and MLP kernels and the packed attention kernel: plain versions here,
    Pallas in interpret mode there) against the JAX packed model, within 1e-4
    of the output's max; and the port's packed forward against its own
    unpacked one, event by event (fp32), and its gradients (float64, 1e-6);
  * one packed train step's loss (1e-5 relative) and every gradient (1e-4 of
    its own max) against the JAX ``_train_step_impl`` path, with the port's
    attention dense or through the plain K7/K8/K9 behind ``_PackedAttention``;
  * ``SRTrainer.fit`` with ``packed: true``: batches, per-epoch order, the
    refusal of an event longer than a row.
"""

import copy
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolutionhep_tpu.data import packing as jpacking
from superresolutionhep_tpu.models.flow_model import FlowModel as JFlowModel
from superresolutionhep_tpu.ops import flash_packed as jfp
from superresolutionhep_tpu.ops import masked as jmasked
from superresolutionhep_tpu_torch.data import packing as tpacking
from superresolutionhep_tpu_torch.data.sr_dataset import MODEL_BATCH_KEYS, SupResEvents, collate
from superresolutionhep_tpu_torch.data.synthetic import GeneratorConfig, generate_events
from superresolutionhep_tpu_torch.models.flow_model import FlowModel
from superresolutionhep_tpu_torch.ops import masked as tmasked
from superresolutionhep_tpu_torch.tools.convert import init_params_jax_layout, params_from_jax
from superresolutionhep_tpu_torch.train.sr_trainer import SRTrainer

from test_flow_model import small_flow_config
from test_torch_port_train import (
    _check_grads, _ref_layout, jax_step, jax_trainer, make_configs, randomize, torch_step)

torch.set_num_threads(1)
S = 768


def _dataset(config_mv, n, seed):
    """Synthetic events of 108, 216 and 324 cells: events that fill 128-cell
    blocks almost exactly and events that straddle a block edge."""
    trees = generate_events(n, seed=seed, config=GeneratorConfig(res_factor=2, max_particles=3, window_lr_cells=1))
    return SupResEvents.from_trees(trees["Low_Tree"], trees["High_Tree"], config_mv)


def _events(config_mv, n, seed):
    ds = _dataset(config_mv, n, seed)
    return [ds.get_event(i) for i in range(n)]


def _packed(events, S=S, rows=1):
    lays = tpacking.pack_events([len(ev.high["eta"]) for ev in events], S=S, rows_per_batch=rows)
    assert len(lays) == 1
    return lays[0], tpacking.collate_packed(events, lays[0], S=S)


def test_packing_equal_to_jax_package():
    """Layouts (first-fit decreasing, empty filler rows), the refusal of an
    oversize event, the collated batch, the one-hot and the segment mean."""
    rng = np.random.default_rng(0)
    counts = list(rng.integers(1, 1000, size=40)) + [128, 256, 1024, 1]
    for S_, rows in ((1024, 2), (5120, 8), (2048, 3)):
        ours = tpacking.pack_events(counts, S=S_, rows_per_batch=rows)
        theirs = jpacking.pack_events(counts, S=S_, rows_per_batch=rows)
        assert [b.rows for b in ours] == [b.rows for b in theirs] and ours[-1].n_events == theirs[-1].n_events
    for fn in (tpacking.pack_events, jpacking.pack_events):
        with pytest.raises(ValueError):
            fn([2000], S=1024)
    assert tpacking.aligned_len(129) == jpacking.aligned_len(129) == 256
    mv, _ = make_configs()
    events = _events(mv, 5, 7)
    lay = tpacking.pack_events([len(ev.high["eta"]) for ev in events], S=512, rows_per_batch=3)[0]
    ours, theirs = tpacking.collate_packed(events, lay, 512), jpacking.collate_packed(events, lay, 512)
    assert set(ours) == set(theirs)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype and np.array_equal(ours[k], theirs[k]), k
    x = rng.normal(size=(3, 512, 6)).astype(np.float32)
    oh_t = tmasked.segment_onehot(torch.from_numpy(ours["seg"]), 4, torch.float32)
    oh_j = jmasked.segment_onehot(jnp.asarray(ours["seg"]), 4, jnp.float32)
    assert np.array_equal(oh_t.numpy(), np.asarray(oh_j))
    np.testing.assert_allclose(tmasked.segment_mean(torch.from_numpy(x), oh_t).numpy(),
                               np.asarray(jmasked.segment_mean(jnp.asarray(x), oh_j)), rtol=1e-6, atol=1e-6)


def _wide_config():
    """F = 128, 2 heads of 64: the fused and packed kernel gates pass."""
    fm = small_flow_config("DiT")
    return dict(fm, h_dim=128, feat_0_mlp=dict(fm["feat_0_mlp"], output_size=128),
                transformer=dict(fm["transformer"], num_heads=2,
                                 dense_config=dict(fm["transformer"]["dense_config"], hidden_layers=[128])))


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_packed_flow_model_matches_jax(fused):
    """The same converted weights give the same packed forward in both
    packages; unfused, the port's packed rows also match its own unpacked
    batch event by event."""
    fm = _wide_config() if fused else small_flow_config("DiT")
    mv, _ = make_configs(fm)
    events = _events(mv, 3, 21)
    lay, hb = _packed(events)
    tree = init_params_jax_layout(fm, seed=3)  # Xavier adaLN: attention not gated off
    t_val = 0.37
    impl = "flash" if fused else "auto"
    saved = dict(jfp.PACKED_DEFAULTS)
    try:
        jfp.set_packed_defaults(block_q=128, block_k=128, max_segment_len=S)
        jmodel = JFlowModel(config=fm, attn_impl=impl, fused_prologue=fused)
        jb = {k: jnp.asarray(v) for k, v in hb.items()}
        want = np.asarray(jax.jit(jmodel.apply)({"params": tree}, jb, jb["target"],
                                                jnp.full((1,), t_val, jnp.float32)))
    finally:
        jfp.PACKED_DEFAULTS.update(saved)
    model = FlowModel(fm, attn_impl=impl, fused_prologue=fused)
    model.load_reference_state_dict(params_from_jax(tree, fm))
    tb = {k: torch.from_numpy(v) for k, v in hb.items()}
    with torch.no_grad():
        got = model(tb, tb["target"], torch.full((1,), t_val)).numpy()
    scale = float(np.abs(want).max())
    assert np.abs(got - want).max() <= 1e-4 * scale
    if not fused:
        ub = collate(events, 384)
        with torch.no_grad():
            unp = model({k: torch.from_numpy(ub[k]) for k in MODEL_BATCH_KEYS}, torch.from_numpy(ub["target"]),
                        torch.full((len(events),), t_val)).numpy()
        for idx, off, n in lay.rows[0]:
            np.testing.assert_allclose(got[0, off: off + n, 0], unp[idx, :n, 0], rtol=2e-4, atol=2e-5)
        # the two layouts are the same function of the weights: in float64 the
        # gradients of the valid cells' sum agree to 1e-6 of each leaf's max (not
        # to float64 rounding: the geometry embedder always runs in fp32), with
        # the floor of _check_grads for the key biases, zero in exact arithmetic
        model.double()
        grads = []
        for b, n_rows in ((hb, 1), (ub, len(events))):
            tb = {k: torch.from_numpy(b[k]).double() if b[k].dtype == np.float32 else torch.from_numpy(b[k])
                  for k in (*MODEL_BATCH_KEYS, "seg") if k in b}
            v = model(tb, tb["target"], torch.full((n_rows,), t_val, dtype=torch.float64))
            grads.append(torch.autograd.grad((v[..., 0] * tb["q_mask"]).sum(), list(model.parameters())))
        top = max(float(g.abs().max()) for g in grads[1])
        for (name, _), a, b in zip(model.named_parameters(), *grads):
            assert float((a - b).abs().max()) <= 1e-6 * max(float(b.abs().max()), 1e-3 * top), name


@pytest.fixture(scope="module")
def jax_packed_step():
    """The JAX package's packed step (dense attention), 2 heads of 16, on two
    rows of five events, from randomised weights."""
    fm = dict(small_flow_config("DiT"))
    fm["transformer"] = dict(fm["transformer"], num_heads=2)
    config_mv, config_t = make_configs(fm)
    jtr, fresh = jax_trainer(config_mv, config_t)
    params = randomize(fresh, 5)
    _, hb = _packed(_events(config_mv, 5, 22), rows=2)
    key = jax.random.PRNGKey(29)
    jloss, jgrads, _ = jax_step(jtr, params, hb, key, with_update=False)
    return dict(fm=fm, config_mv=config_mv, config_t=config_t, params=params, hb=hb, key=key, jloss=jloss,
                jgrads=jgrads)


@pytest.mark.parametrize("attn", ["auto", "flash"], ids=["dense", "kernels"])
def test_packed_train_step_matches_jax(tmp_path, jax_packed_step, attn):
    """One packed train step: loss within 1e-5 relative and every gradient
    within 1e-4 of its max against the JAX package's step on the same packed
    batch, weights and draws."""
    r = jax_packed_step
    tloss, tgrads, _ = torch_step(tmp_path, r["config_mv"], r["config_t"], r["params"], r["hb"], r["key"], attn=attn)
    assert np.isfinite(tloss) and abs(tloss - r["jloss"]) <= 1e-5 * abs(r["jloss"])
    _check_grads(tgrads, _ref_layout(r["jgrads"], r["fm"]), 1e-4)


def test_packed_fit(tmp_path):
    """``fit`` with ``packed: true`` trains on the packed layout (one batch per
    layout, order permuted per epoch) and validates bucketed; an event longer
    than a row raises before any step."""
    config_mv, config_t = make_configs(num_epochs=2, packed=True, pack_s=512, pack_rows=2)
    train_ds, val_ds = _dataset(config_mv, 9, 31), _dataset(config_mv, 2, 32)
    assert max(train_ds.cell_count_high) > 256
    n_layouts = len(tpacking.pack_events(train_ds.cell_count_high, S=512, rows_per_batch=2))
    tr = SRTrainer(config_mv, config_t, run_dir=str(tmp_path / "run"), seed=0, device="cpu")
    seen = []
    hook = tr.model.register_forward_pre_hook(
        lambda _m, args: seen.append(tuple(args[0]["seg"].shape)) if torch.is_grad_enabled() else None)
    tr.fit(train_ds, val_ds)
    hook.remove()
    assert tr.global_step == 2 * n_layouts and set(seen) == {(2, 512)}
    lines = [json.loads(x) for x in open(tmp_path / "run" / "metrics.jsonl")]
    assert [x["train/n_batches"] for x in lines] == [n_layouts, n_layouts]
    assert all(np.isfinite(x["train/loss"]) and np.isfinite(x["val/loss_raw"]) for x in lines)
    small = copy.deepcopy(config_t)
    small["pack_s"] = 256
    tr2 = SRTrainer(config_mv, small, run_dir=str(tmp_path / "run2"), seed=0, device="cpu")
    with pytest.raises(ValueError, match="exceed pack_s"):
        tr2.fit(train_ds, val_ds)
