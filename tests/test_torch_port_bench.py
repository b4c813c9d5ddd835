"""PyTorch port, the bench (``superresolutionhep_tpu_torch/scripts/bench.py``)
and ``scripts/measure_train_bench.py`` against the JAX package's ``bench.py``
(loaded by path) on the CPU:

* the batch plans on 16 bench events, bucketed (exact and pow2 tails) and
  packed: every batch's shape, real events, cell counts and collated arrays
  equal bit for bit to the JAX bench's (its HDF5 file written here), and each
  batch's padded, masked and attention flops equal to the JAX accounting;
* the sampler call on the tools' CPU model in fp32 (weights carried by
  ``params_from_jax``, x0 from ``jax.random.normal``) against the JAX
  ``generate_ensemble`` within 1e-4 of the max, and the no-max self-check's
  verdict equal to the JAX one, with logits inside and outside the clip;
* ``_train_bench``'s and ``_pf_train_bench``'s host batches and settings (the
  JAX functions run until they hand their batch to the trainer) bit for bit,
  ``train_step_flops`` at the two bench shapes, one SR leg and the PF step at
  (2, 128) on the CPU with every JAX key;
* ``_pf_bench``'s batch (captured the same way), and at (2, 128) the argmax,
  kinematics (1e-5) and assignment (exact) of the port's PF hot path against
  the JAX forward plus ``set_to_set_incidence_loss``, the fused prologue
  asked for and its unfused route taken at h 64;
* both CLIs with ``--device cpu``: the headline line with the JAX keys plus
  ``degraded``, the detail keys a superset of the JAX bench's; ``--device
  cuda`` without a card raises before any work.
"""

import importlib.util
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from superresolutionhep_tpu.data import packing as jpacking
from superresolutionhep_tpu.data.bucketing import BucketBatcher as JBucketBatcher
from superresolutionhep_tpu.data.sr_dataset import SupResEvents as JSupResEvents
from superresolutionhep_tpu.data.sr_dataset import collate as jcollate
from superresolutionhep_tpu.data.synthetic import GeneratorConfig as JGeneratorConfig
from superresolutionhep_tpu.data.synthetic import write_synthetic_file
from superresolutionhep_tpu.flow.sampling import generate_ensemble as jgenerate_ensemble
from superresolutionhep_tpu.losses.set2set import set_to_set_incidence_loss as jset_to_set_incidence_loss
from superresolutionhep_tpu.models.flow_model import FlowModel as JFlowModel
from superresolutionhep_tpu.models.pf import model_pf as jmodel_pf
from superresolutionhep_tpu.ops import flash_packed as jflash_packed
from superresolutionhep_tpu.ops.flash_attention import nomax_selfcheck as jnomax_selfcheck
from superresolutionhep_tpu.tools import flops as jflops
from superresolutionhep_tpu.train import pf_trainer as jpf_trainer
from superresolutionhep_tpu.train import sr_trainer as jsr_trainer
from superresolutionhep_tpu.transforms import build_var_transforms as jbuild_var_transforms
from superresolutionhep_tpu_torch.models import attention as tattention
from superresolutionhep_tpu_torch.models import dit as tdit
from superresolutionhep_tpu_torch.models.flow_model import FlowModel
from superresolutionhep_tpu_torch.ops.flash_packed import PACKED_DEFAULTS
from superresolutionhep_tpu_torch.scripts import bench, common, measure_train_bench
from superresolutionhep_tpu_torch.tools import convert

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def _jax_bench():
    spec = importlib.util.spec_from_file_location("jax_bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _config(name):
    with open(os.path.join(ROOT, "configs", name, "model_and_var.yml")) as fp:
        return yaml.safe_load(fp)


def _jax_flow_params(cfg):
    """The JAX parameter tree's shapes (the counter reads nothing else)."""
    model = JFlowModel(config=cfg["flow_model"], attn_impl="einsum")
    b = {"eta": jnp.zeros((1, 8, 1)), "cosphi": jnp.ones((1, 8, 1)), "sinphi": jnp.zeros((1, 8, 1)),
         "layer": jnp.zeros((1, 8, 1), jnp.int32), "e_proxy": jnp.zeros((1, 8, 1)), "q_mask": jnp.ones((1, 8), bool)}
    return jax.eval_shape(model.init, jax.random.PRNGKey(0), b, jnp.zeros((1, 8, 1)), jnp.zeros((1,)))


def _same_batch(ours, theirs):
    keys = {k for k, v in theirs.items() if isinstance(v, np.ndarray) and k != "idx"}
    assert keys <= set(ours)
    for k in keys:
        assert ours[k].dtype == theirs[k].dtype and np.array_equal(ours[k], theirs[k]), k


def test_batch_plans_and_flops_match_the_jax_bench(tmp_path):
    cfg = _config("multipart")
    path = str(tmp_path / "multipart_16.h5")
    write_synthetic_file(path, n_events=16, seed=42, config=JGeneratorConfig(**bench.GEN))
    jds = JSupResEvents(path, cfg)
    ds = bench.bench_events(cfg, 16, bench.GEN, bench.SEED)
    assert np.array_equal(ds.cell_count_high, jds.cell_count_high)
    model, params = FlowModel(cfg["flow_model"]), _jax_flow_params(cfg)
    fillers = 0
    for tail in ("exact", "pow2"):  # the JAX default, and the tails chip_smoke.py's bench phase runs
        s = bench.settings({"tail": tail}, environ={})
        ours, batcher = bench.bucketed_batches(ds, s)
        # bench.py:198-214 and :248-258
        jb = JBucketBatcher(jds.cell_count_high, quantum=512, fine_quantum=None, fine_above=3072,
                            cost_budget=4096 * 4096 * 16, max_batch_size=64, shuffle=False, tail_shrink=tail,
                            merge_tail_up=0)
        theirs = list(jb)
        assert [(b.pad_n, b.batch_size) for b in batcher.buckets] == [(b.pad_n, b.batch_size) for b in jb.buckets]
        assert len(ours) == len(theirs)
        for (hb, n_real, nv), (idxs, bucket) in zip(ours, theirs):
            _same_batch(hb, jcollate([jds.get_event(i) if i >= 0 else None for i in idxs], bucket.pad_n))
            assert n_real == int((idxs >= 0).sum()) and nv == [jds.cell_count_high[i] for i in idxs if i >= 0]
            fillers += len(idxs) - n_real
            B, N = hb["eta"].shape[:2]
            f = jflops.flow_model_flops(params, cfg, B, N, n_valid=nv)
            assert bench.batch_flops(model, cfg, hb, nv, False) == (f["total"], f["total_masked"], f["attention"])
        assert sum(n for _, n, _ in ours) == 16
    assert fillers > 0  # the pow2 tails leave filler rows out of the event count

    # packed: bench.py:226-246, the flops at bench.py:325-332
    saved_j, saved_t = dict(jflash_packed.PACKED_DEFAULTS), dict(PACKED_DEFAULTS)
    try:
        s = bench.settings({"packed": 1}, environ={})
        ours = bench.packed_batches(ds, s)
        assert (PACKED_DEFAULTS["block_q"], PACKED_DEFAULTS["block_k"]) == (256, 256)
        jflash_packed.set_packed_defaults(block_q=256, block_k=256,
                                          max_segment_len=-(-int(max(jds.cell_count_high)) // 128) * 128)
        layouts = jpacking.pack_events(jds.cell_count_high, S=5120, rows_per_batch=12)
        assert len(ours) == len(layouts)
        for (hb, n_real, nv), lay in zip(ours, layouts):
            _same_batch(hb, jpacking.collate_packed({i: jds.get_event(i) for r in lay.rows for i, _, _ in r}, lay,
                                                    S=5120))
            assert n_real == lay.n_events and nv == [n for row in lay.rows for (_, _, n) in row]
            f = jflops.flow_model_flops_packed(params, cfg, hb["seg"], 256, 256)
            assert bench.batch_flops(model, cfg, hb, nv, True) == (f["total"], f["total_masked"], f["attention"])
    finally:
        jflash_packed.PACKED_DEFAULTS.update(saved_j)
        PACKED_DEFAULTS.update(saved_t)


def _small_batch(rng, B, N):
    valid = np.arange(N)[None, :] < np.asarray([N, N - 37])[:B, None]
    phi = rng.uniform(-3, 3, size=(B, N, 1)).astype(np.float32)
    return {"eta": rng.uniform(-1, 1, size=(B, N, 1)).astype(np.float32), "cosphi": np.cos(phi),
            "sinphi": np.sin(phi), "layer": rng.integers(0, 3, size=(B, N, 1)).astype(np.int32),
            "e_proxy": rng.normal(size=(B, N, 1)).astype(np.float32), "q_mask": valid}


def test_sampler_call_and_selfcheck_match_jax():
    cfg = common.tiny_config_mv()["flow_model"]
    B, N, E, n_steps = 2, 128, 2, 4
    batch = _small_batch(np.random.default_rng(3), B, N)
    jb, tb = {k: jnp.asarray(v) for k, v in batch.items()}, {k: torch.from_numpy(v) for k, v in batch.items()}
    tree = convert.init_params_jax_layout(cfg, seed=0)  # the bench's weights
    jfast = JFlowModel(config=cfg, attn_impl="flash_nomax", fused_prologue=True)
    key = jax.random.PRNGKey(1)
    want = np.asarray(jgenerate_ensemble(lambda v, b, x, t: jfast.apply(v, b, x, t), {"params": tree}, jb, key,
                                         n_ensemble=E, n_steps=n_steps, method=bench.METHOD, ret_seq=False))
    x0 = np.stack([np.asarray(jax.random.normal(k, (B, N, 1), jnp.float32)) for k in jax.random.split(key, E)])
    fast = FlowModel(cfg, attn_impl="flash_nomax", fused_prologue=True).eval()
    fast.load_reference_state_dict(convert.params_from_jax(tree, cfg))
    got = bench.sampler_call(fast, tb, n_ensemble=E, n_steps=n_steps, x0=torch.from_numpy(x0)).numpy()
    assert got.shape == want.shape == (E, B, N, 1)
    valid = np.broadcast_to(batch["q_mask"][None, :, :, None], got.shape)
    assert np.abs(got - want)[valid].max() <= 1e-4 * np.abs(want)[valid].max()

    # the self-check, at a head dim the kernels take (h 64: 4 heads of 16; at the CPU model's 8
    # both packages take the dense path, no-max or not): logits inside the clip, then queries and
    # keys scaled far outside it
    cfg = dict(cfg, h_dim=64, feat_0_mlp=dict(cfg["feat_0_mlp"], output_size=64),
               transformer=dict(cfg["transformer"], dense_config=dict(cfg["transformer"]["dense_config"],
                                                                      hidden_layers=[64])))
    jfast = JFlowModel(config=cfg, attn_impl="flash_nomax", fused_prologue=True)
    fast = FlowModel(cfg, attn_impl="flash_nomax", fused_prologue=True).eval()
    jrobust = JFlowModel(config=cfg)
    x, tt = jnp.zeros_like(jb["e_proxy"]), jnp.full((B,), 0.5, jnp.float32)
    jr, jf = (jax.jit(lambda p, b, m=m: m.apply({"params": p}, b, x, tt)) for m in (jrobust, jfast))
    for scale in (1.0, 300.0):
        t = _scaled(convert.init_params_jax_layout(cfg, seed=0), scale)
        jv = jnomax_selfcheck(lambda b: jr(t, b), lambda b: jf(t, b), jb)
        robust = FlowModel(cfg).eval()
        robust.load_reference_state_dict(convert.params_from_jax(t, cfg))
        fast.load_reference_state_dict(convert.params_from_jax(t, cfg))
        with torch.no_grad():
            ok, diff = bench.selfcheck(robust, fast, tb)
        assert ok == jv == (scale == 1.0) == (diff < 6e-2), (scale, diff)


def _scaled(tree, scale):
    """The tree with every attention query/key projection times ``scale``."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        return np.asarray(node) * scale if path[-2:] in (("linear_q", "kernel"), ("linear_k", "kernel")) else node
    return walk(tree, ())


class _Captured(Exception):
    pass


def _capture(monkeypatch, module, name):
    """``module.name`` replaced by a class whose construction records its
    arguments and whose ``_device_batch``/``init`` raises with the batch."""
    seen = {}

    class Fake:
        def __init__(self, *args, **kw):
            seen["args"], seen["kw"] = args, kw

        def _device_batch(self, host):
            raise _Captured(host)

        def init(self, key, batch):
            raise _Captured(batch)

    monkeypatch.setattr(module, name, Fake)
    return seen


def test_train_benches_match_the_jax_bench(monkeypatch):
    jbench, cfg = _jax_bench(), _config("multipart")
    for B, N, fused, remat in ((8, 2048, False, True), (6, 3584, True, False)):
        seen = _capture(monkeypatch, jsr_trainer, "SRTrainer")
        with pytest.raises(_Captured) as host:
            jbench._train_bench(jax, jnp, np, cfg, B=B, N=N, fused=fused, remat=remat)
        _same_batch(bench.sr_train_host_batch(B, N), host.value.args[0])
        assert seen["args"][1] == bench.sr_train_config(N, fused, remat)
    seen = _capture(monkeypatch, jpf_trainer, "PFTrainer")
    with pytest.raises(_Captured) as host:
        jbench._pf_train_bench(jax, jnp, np, ROOT)
    _same_batch(bench.pf_train_host_batch(25, 2048, 4), host.value.args[0])
    assert seen["args"][1] == bench.pf_train_config(2048)
    monkeypatch.undo()

    model, params = FlowModel(cfg["flow_model"]), _jax_flow_params(cfg)
    for B, N in ((8, 2048), (6, 3584)):
        for remat in (True, False):
            assert (bench.train_step_flops(model, cfg, B, N, remat=remat)
                    == jflops.train_step_flops(params, cfg, B, N, remat=remat))
    # one leg and the PF step on the CPU, with every field of the JAX functions' results (bench.py:557-569, :629-633)
    leg = bench.train_bench(CPU, common.tiny_config_mv(), B=2, N=128, n_rep=1)
    assert {"steps_per_sec", "events_per_sec", "batch", "fused_prologue", "remat", "train_tfs_executed",
            "train_tfs_useful", "train_mfu", "train_mfu_useful"} <= set(leg)
    assert leg["batch"] == [2, 128] and leg["steps_per_sec"] > 0 and leg["train_mfu"] is None  # no device figure
    pf = bench.pf_train_bench(CPU, B=2, N=128, n_rep=1)
    assert set(pf) == {"steps_per_sec", "events_per_sec", "batch"} and pf["batch"] == [2, 128]


def test_pf_bench_matches_jax_forward_and_assignment(monkeypatch):
    jbench, cfg = _jax_bench(), _config("pflow")
    B, N, P = 2, 128, int(cfg["pf_model"]["max_particles"])
    seen = _capture(monkeypatch, jmodel_pf, "SAPF")
    with pytest.raises(_Captured) as captured:
        jbench._pf_bench(jax, jnp, np, ROOT, B=B, N=N)
    monkeypatch.undo()
    jb = captured.value.args[0]
    _same_batch(bench.pf_bench_batch(B, N, P), {k: np.asarray(v) for k, v in jb.items()})
    assert seen["kw"]["inference"] is True and seen["kw"]["fused_prologue"] is True

    jm = jmodel_pf.SAPF(config_pf=cfg["pf_model"], transforms=jbuild_var_transforms(cfg["var_transform"]),
                        inference=True, fused_prologue=True, attn_impl="xla")
    # seeded leaves (the zero adaLN gates of an init would switch attention off), shapes from the init's trace
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: ((1.0 if "scale" in jax.tree_util.keystr(path) else 0.0)
                         + 0.1 * rng.normal(size=a.shape)).astype(np.float32),
        jax.eval_shape(jm.init, jax.random.PRNGKey(0), jb)["params"])
    head = [p for p, a in jax.tree_util.tree_flatten_with_path(params)[0]
            if "cardinality" in jax.tree_util.keystr(p) and a.shape == (P + 1,)][-1]
    params = jax.tree_util.tree_map_with_path(  # the cardinality head's bias: 3 particles in each event
        lambda p, a: a + 20.0 * (np.arange(P + 1) == 3) if p == head else a, params)
    logits, kin, inc = jm.apply({"params": params}, jb)
    _, _, assign = jset_to_set_incidence_loss(inc, jb, kin)
    n_pred, kin, assign = np.asarray(jnp.argmax(logits, -1)), np.asarray(kin), np.asarray(assign)

    def refuse(*a, **k):
        raise AssertionError("the fused kernels were asked for at h 64")

    monkeypatch.setattr(tattention, "fused_ln_mod_proj", refuse)
    monkeypatch.setattr(tdit, "fused_dit_mlp", refuse)
    model = bench.pf_model(cfg, CPU, fused=True, params=convert.pf_params_from_jax(params, cfg["pf_model"]),
                           attn_impl="flash")  # the kernels' plain versions on the CPU, as the card's "auto"
    assert model.encoder.transformer.layers[0].fused_prologue  # asked for; the gate (F % 128) routes around it
    got = bench.pf_forward(model, {k: torch.from_numpy(np.asarray(v)) for k, v in jb.items()})
    assert np.array_equal(got[0].numpy(), n_pred)
    assert (n_pred == 3).all()
    pm = np.arange(P)[None] < n_pred[:, None]
    assert np.abs(got[1].numpy() - kin)[pm].max() <= 1e-5 * max(np.abs(kin[pm]).max(), 1.0)
    assert np.array_equal(got[2].numpy(), assign)


def test_the_clis_on_the_cpu(tmp_path, monkeypatch, capsys):
    src = open(os.path.join(ROOT, "bench.py")).read()
    block = src[src.index('"detail": {'):src.index("file=sys.stderr", src.index('"detail": {'))]
    jax_detail = set(re.findall(r'"(\w+)":', block)) - {"detail"}
    monkeypatch.setitem(bench.DEGRADED, "n_events", 4)  # the degraded mode's 16 events, cut for the test's time
    line, detail = bench.main(["--device", "cpu"])
    out = capsys.readouterr()
    last = json.loads(out.out.strip().splitlines()[-1])
    assert last == line and set(last) == {"metric", "value", "unit", "vs_baseline", "degraded"}
    assert last["metric"] == "sr_inference_events_per_sec_per_chip_nsteps25_ens10" and last["degraded"] == "cpu-backend"
    assert last["vs_baseline"] is None and last["value"] > 0
    err = json.loads(out.err.strip().splitlines()[-1])["detail"]
    assert jax_detail <= set(err) and err["n_events"] == 4 and err["nomax_selfcheck_ok"] is True
    assert err["mfu_vs_measured_chip_peak"] is None and err["measured_chip_tfs"] is None  # no device figure

    res = measure_train_bench.main(["--device", "cpu", "--out", str(tmp_path / "train_bench.json")])
    assert json.load(open(tmp_path / "train_bench.json")) == json.loads(json.dumps(res))
    assert [(r["batch"], r["fused_prologue"], r["remat"]) for r in res["sr_train"]] == [
        ([2, 128 if leg["N"] == 2048 else 256], leg["fused"], leg["remat"]) for leg in measure_train_bench.LEGS]
    assert not any("error" in r for r in res["sr_train"]) and "error" not in res["pf_train"]

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (bench.main, measure_train_bench.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--device", "cuda"])
