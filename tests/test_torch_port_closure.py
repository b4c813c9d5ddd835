"""PyTorch port, the closure and substructure pipelines against the JAX
package's scripts, on the same files (CPU).

The files are made by the port itself at a small width (the multipart layout
cut to h 32 and 2 DiT layers, the stage-2 model to h 32 and 2 + 2 layers,
random weights from a seed): ten synthetic multi-particle events through
``SRInference.run_pred`` (several batches, ensemble components, the energy
incidence branches), then ``PFInference.run_pred`` at low and at high
resolution.  The port's and the JAX package's run_pred both write PF rows in
event order; the reference writes them in batch order, so the PF files are
also written with their rows shuffled (``idx`` out of order), which the
analysis must undo.  No JAX inference runs: the JAX side is the scripts'
metric and analysis code, loaded by path.

Both sides are numpy code on the same arrays, so the metrics are held to
rtol 1e-12 (summation order aside they are equal).  The whole closure suite
at its smallest (``--n-train 32 --epochs 1 --n-ensemble 2 --n-steps 3``)
takes minutes on the CPU and is not run here; README names its command."""

import importlib.util
import json
import os
import shutil
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # run as a script too

from superresolutionhep_tpu_torch.data import root_io  # noqa: E402
from superresolutionhep_tpu_torch.data.jagged import JaggedArray  # noqa: E402
from superresolutionhep_tpu_torch.data.pf_dataset import PflowEvents  # noqa: E402
from superresolutionhep_tpu_torch.data.sr_dataset import SupResEvents  # noqa: E402
from superresolutionhep_tpu_torch.data.synthetic import GeneratorConfig, write_synthetic_file  # noqa: E402
from superresolutionhep_tpu_torch.inference.pf import PFInference  # noqa: E402
from superresolutionhep_tpu_torch.inference.sr import SRInference  # noqa: E402
from superresolutionhep_tpu_torch.scripts import closure_pf_hr_vs_lr as hl  # noqa: E402
from superresolutionhep_tpu_torch.scripts import closure_pf_suite as cps  # noqa: E402
from superresolutionhep_tpu_torch.scripts import closure_suite as cs  # noqa: E402
from superresolutionhep_tpu_torch.scripts import (compute_scale, merge_substructures, plot_pf_hr_vs_lr,  # noqa: E402
                                                  plot_substructures, submit_substructures)
from superresolutionhep_tpu_torch.tools.convert import (init_params_jax_layout, init_pf_params_jax_layout,  # noqa: E402
                                                        params_from_jax, pf_params_from_jax)

from test_torch_port_pf_model import small_pf_config  # noqa: E402
from test_torch_port_train import make_configs  # noqa: E402

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-12
N_EVENTS = 10
SR_ITEM = {"n_ensemble": 2, "ode_method": "ab2e", "seed": 3, "batch_size": 4, "save_ensemble_components": True,
           "store_energy_incidence": True, "max_particles": 4}
PF_T = {"loss_on_inc_wts": True, "energy_threshold": 1.0, "bucket_quantum": 64, "card_loss_weight": 0.5}


def jax_script(name):
    """The JAX package's ``scripts/<name>.py``, loaded by path."""
    spec = importlib.util.spec_from_file_location(f"jax_scripts_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def shuffled_rows(tree, seed):
    """A ``Particle_Tree`` with its rows in another order (``idx`` unsorted)."""
    perm = np.random.default_rng(seed).permutation(len(np.asarray(tree["idx"])))
    assert (np.diff(perm) < 0).any()
    return {k: (JaggedArray.from_list([np.asarray(v[i]) for i in perm]) if isinstance(v, JaggedArray)
                else np.asarray(v)[perm]) for k, v in tree.items()}


def make_closure_files(d):
    """The port's stage-1 and stage-2 outputs of ten small events, as files
    and as the trees ``predict`` returns: ``paths`` (truth, sr, pf_low,
    pf_high and the shuffled pf_low_shuffled / pf_high_shuffled) and
    ``trees`` (sr, pf_low, pf_high)."""
    d = str(d)
    config_mv, config_t = make_configs(bucket_quantum=64)
    flow = config_mv["flow_model"]
    flow["transformer"]["num_transformer_layers"] = 2
    truth = write_synthetic_file(os.path.join(d, "truth.h5"), N_EVENTS, seed=7,
                                 config=GeneratorConfig(max_particles=4, window_lr_cells=1))
    params = params_from_jax(init_params_jax_layout(flow, seed=1), flow)
    sr = SRInference({"model": {"config_mv": config_mv, "config_t": config_t, "checkpoint_path": None,
                                "n_steps": 3, "n_steps_to_store": 1}}, params=params, device="cpu")
    paths = {"truth": truth, "sr": os.path.join(d, "sr_pred_0_10.h5")}
    sr.run_pred(dict(SR_ITEM, truth_path=truth, pred_path=paths["sr"], n_events=N_EVENTS))
    ds = SupResEvents(truth, config_mv, make_low=True, make_particles=True)
    trees = {"sr": sr.predict(ds, SR_ITEM)}

    pf_cfg = small_pf_config()
    pf_params = pf_params_from_jax(init_pf_params_jax_layout(pf_cfg["pf_model"], seed=2), pf_cfg["pf_model"])
    for res in ("low", "high"):
        inf = PFInference({"model": {"config_mv": pf_cfg, "config_t": dict(PF_T, resolution=res),
                                     "checkpoint_path": None}, "batch_size": 4}, params=pf_params, device="cpu")
        paths[f"pf_{res}"] = os.path.join(d, f"pf_{res}", "pf_test_pred.h5")
        inf.run_pred({"glob_arg": paths["sr"], "pred_path": paths[f"pf_{res}"], "store_inc_wt": True})
        pf_ds = PflowEvents.from_trees(trees["sr"], pf_cfg, energy_threshold=1.0, res=res, load_incidence=True)
        trees[f"pf_{res}"] = inf.predict(pf_ds, {"store_inc_wt": True})
        shuffled = os.path.join(d, f"pf_{res}_shuffled", "pf_test_pred.h5")
        os.makedirs(os.path.dirname(shuffled))
        root_io.write_trees(shuffled, {"Particle_Tree": shuffled_rows(
            root_io.read_tree(paths[f"pf_{res}"], "Particle_Tree"), seed=len(res))})
        paths[f"pf_{res}_shuffled"] = shuffled
    return paths, trees


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return make_closure_files(tmp_path_factory.mktemp("closure"))


def assert_same(got, want, path=""):
    """Nested metrics equal: keys, ints and strings exactly, floats to RTOL."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple, np.ndarray)) and not isinstance(want, str):
        np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=RTOL, err_msg=path)
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=RTOL, abs=0.0), path
    else:
        assert got == want and type(got) is type(want), path


def test_compute_scale_matches_jax(files, capsys):
    """``compute_target_stats`` and the YAML printer of ``compute_scale``."""
    paths, _ = files
    jcs = jax_script("compute_scale")
    for stop in (None, 6):
        got = compute_scale.compute_target_stats(paths["truth"], entry_stop=stop)
        want = jcs.compute_target_stats(paths["truth"], entry_stop=stop)
        assert_same(list(got), list(want))
    argv = ["-fp", paths["truth"], "--target", "--entry_stop", "8"]
    compute_scale.main(argv)
    mine = capsys.readouterr().out
    jcs.main(argv)
    assert mine == capsys.readouterr().out and "target_transform" in mine


def test_sr_closure_evaluate_matches_jax(files):
    """The SR closure metrics: the file version and the core on the
    in-memory ``High_Tree`` of ``predict`` against the JAX suite's
    ``evaluate`` (the first divides the proxy by rf^2, a wrong split moves
    every naive residual)."""
    paths, trees = files
    want = jax_script("closure_suite").evaluate(paths["truth"], paths["sr"])
    assert want["n_cells"] > 100 and set(want["per_layer"]) == {"0", "1", "2"}
    assert_same(cs.evaluate(paths["truth"], paths["sr"]), want)
    assert_same(cs.closure_metrics(trees["sr"]["High_Tree"]), want)
    assert_same(cs.evaluate(paths["truth"], paths["sr"], rf=4, e_min_mev=5.0),
                jax_script("closure_suite").evaluate(paths["truth"], paths["sr"], rf=4, e_min_mev=5.0))


def test_pf_closure_evaluates_match_jax(files, tmp_path):
    """``closure_pf_suite.evaluate`` and ``closure_pf_hr_vs_lr.evaluate``
    (low and high) on the files, in event order and shuffled, and their
    cores on the in-memory trees, against the JAX scripts; the
    ``plot_pf_hr_vs_lr`` residuals and figures."""
    paths, trees = files
    jps, jhl, jplot = jax_script("closure_pf_suite"), jax_script("closure_pf_hr_vs_lr"), jax_script("plot_pf_hr_vs_lr")
    for tag in ("pf_low", "pf_low_shuffled"):
        want = jps.evaluate(paths[tag], sr_test_glob=paths["sr"])
        assert "incidence_mae" in want and want["n_events"] == N_EVENTS
        assert_same(cps.evaluate(paths[tag], sr_test_glob=paths["sr"]), want)
    assert_same(cps.pf_closure_metrics(trees["pf_low"]["Particle_Tree"], trees["sr"]["Low_Tree"]),
                jps.evaluate(paths["pf_low"], sr_test_glob=paths["sr"]))
    results = {}
    for res in ("low", "high"):
        for tag in (f"pf_{res}", f"pf_{res}_shuffled"):
            want = jhl.evaluate(paths[tag], paths["sr"], res)
            assert "incidence_mae" in want
            assert_same(hl.evaluate(paths[tag], paths["sr"], res), want)
        cell = trees["sr"]["High_Tree" if res == "high" else "Low_Tree"]
        assert_same(hl.pf_metrics(trees[f"pf_{res}"]["Particle_Tree"], res, cell), want)
        results[f"pf_{res}"] = want
        for k, v in jplot.residuals(paths[f"pf_{res}_shuffled"]).items():
            np.testing.assert_array_equal(plot_pf_hr_vs_lr.residuals(paths[f"pf_{res}_shuffled"])[k], v)
    comparison, gate = hl.compare(results["pf_low"], results["pf_high"])
    out = tmp_path / "run"
    for res in ("low", "high"):
        shutil.copytree(os.path.dirname(paths[f"pf_{res}"]), out / f"pf_{res}")
    with open(out / "closure_pf_hr_vs_lr.json", "w") as fp:
        json.dump(dict(results, comparison=comparison, gate_hr_beats_lr=gate), fp)
    figs = plot_pf_hr_vs_lr.main(["--outdir", str(out), "--figdir", str(tmp_path / "figs")])
    assert all(os.path.getsize(p) > 0 for p in figs)


def _chain(mod_submit, mod_merge, sr_path):
    mod_submit.main(["-fp", sr_path, "-cs", "5", "--workers", "1"])
    sd = os.path.join(os.path.dirname(sr_path), "substructures")
    mod_merge.main(["-sd", sd])
    return sd, root_io.read_tree(os.path.join(sd, "substructures.h5"), "substructures")


def test_substructure_chain_matches_jax(files, tmp_path, monkeypatch):
    """submit (local backend, one worker, two chunks, one process each) ->
    compute -> merge, the port's scripts against the JAX package's on copies
    of the same SR file: every merged array equal; the figures and metrics
    of ``plot_substructures`` equal too."""
    paths, _ = files
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        # the chunk processes inherit it: one BLAS thread each beside the test workers
        monkeypatch.setenv(var, "1")
    runs = {}
    for side in ("port", "jax"):
        os.makedirs(tmp_path / side)
        runs[side] = shutil.copy(paths["sr"], str(tmp_path / side / "sr_pred.h5"))
    sd, got = _chain(submit_substructures, merge_substructures, runs["port"])
    jsubmit = jax_script("submit_substructures")
    # its jobs are processes of their own: a thread pool runs them without
    # pickling a function of a module loaded by path
    monkeypatch.setattr(jsubmit, "ProcessPoolExecutor", ThreadPoolExecutor)
    jsd, want = _chain(jsubmit, jax_script("merge_substructures"), runs["jax"])
    assert not os.listdir(os.path.join(sd, "status")) and len(os.listdir(sd)) == 4  # 2 chunks, merged, status/
    assert sorted(got) == sorted(want) and len(want) == 12
    for k in want:
        assert np.asarray(want[k]).shape == (N_EVENTS,)
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    metrics = {}
    for side, mod, d in (("port", plot_substructures, sd), ("jax", jax_script("plot_substructures"), jsd)):
        mod.main(["-i", os.path.join(d, "substructures.h5"), "--fig-dir", str(tmp_path / side / "figs"),
                  "--json", str(tmp_path / side / "m.json")])
        with open(tmp_path / side / "m.json") as fp:
            metrics[side] = json.load(fp)
        assert all(os.path.getsize(p) > 0 for p in metrics[side].pop("figures"))
    assert_same(metrics["port"], metrics["jax"])


def test_closure_configs_and_chunk_plan_match_jax(files, tmp_path, monkeypatch, capsys):
    """``closure_suite.write_configs`` (the transform statistics fitted on
    the training file, the training settings) writes the JAX suite's YAML
    pair; ``submit_inference_chunks`` plans the JAX script's entry ranges."""
    import yaml

    paths, _ = files
    monkeypatch.chdir(ROOT)  # the JAX suite reads its base configs relative to the working directory
    split = {"train": paths["truth"], "val": paths["truth"]}
    for side in ("port", "jax"):
        os.makedirs(tmp_path / side)
    got = cs.write_configs(str(tmp_path / "port"), split, 7, fourier=9, lr=3e-4)
    want = jax_script("closure_suite").write_configs(str(tmp_path / "jax"), split, 7, fourier=9, lr=3e-4)
    for g, w in zip(got, want):
        with open(g) as a, open(w) as b:
            mine, ref = yaml.safe_load(a), yaml.safe_load(b)
        for c in (mine, ref):  # the train config names its own output directory
            c.pop("base_root_dir", None)
        assert mine == ref

    from superresolutionhep_tpu_torch.scripts import submit_inference_chunks

    args = ["-i", "inf.yml", "-n", "250", "--entry_start", "10", "-cs", "100", "--backend", "print"]
    jobs = submit_inference_chunks.main(args)
    capsys.readouterr()
    jax_script("submit_inference_chunks").main(args)
    want = [ln.split() for ln in capsys.readouterr().out.splitlines() if "-estart" in ln]
    assert [(a, b) for _, a, b, _ in jobs] == [(int(w[w.index("-estart") + 1]), int(w[w.index("-estop") + 1]))
                                              for w in want] == [(10, 110), (110, 210), (210, 260)]


def jax_sr_reading(out_path, dtype="fp32", attention=None, n_events=256, batch_size=16):
    """The JAX package's SR closure reading on the CPU: ``closure_sr`` from
    its blob on the SR suite's test events (``closure_suite.GEN``, seed 13),
    with the suite's inference settings (10 members, ``ab2e`` at 25 points,
    the JAX package's own noise), in fp32 or with the bf16 stack (``dtype``
    "bf16": the model's ``dtype: bfloat16``, geometry kept fp32), scored by
    the JAX suite's ``evaluate``; written as JSON for chip_smoke.py's closure
    phase.  ``attention``: "einsum", the model's CPU fallback (its scores in
    the operands' dtype), or "reference", the model's kernel path
    (``attn_impl="flash"``, as on a TPU) with the kernel's own plain
    reference in its place (``ops/flash_attention.py::_ref_attention``, fp32
    scores; the Pallas kernel itself would run in interpret mode).  Default:
    einsum in fp32 (the same function there), the reference in bf16 (bf16
    scores round base-2 logits of up to 6e5 by thousands).  Full width: run
    it once, on a machine with time to spare (about 75 minutes in fp32 on 8
    CPU cores)."""
    import tempfile
    from unittest import mock

    import jax

    from superresolutionhep_tpu.data.synthetic import GeneratorConfig as JGeneratorConfig
    from superresolutionhep_tpu.data.synthetic import write_synthetic_file as jwrite_synthetic_file
    from superresolutionhep_tpu.inference.sr import SRInference as JSRInference
    from superresolutionhep_tpu.models.flow_model import FlowModel as JFlowModel
    from superresolutionhep_tpu.ops import flash_attention as jfa

    attention = attention or ("reference" if dtype == "bf16" else "einsum")
    jcs = jax_script("closure_suite")
    ckpt = os.path.join(ROOT, "saved_checkpoints", "closure_sr")
    with tempfile.TemporaryDirectory() as d, mock.patch.object(jfa, "flash_shapes_ok", lambda *a: False):
        truth = jwrite_synthetic_file(os.path.join(d, "test.h5"), n_events, seed=13, config=JGeneratorConfig(**jcs.GEN))
        pred = os.path.join(d, "pred.h5")
        inf = JSRInference({"model": {"config_path_mv": os.path.join(ckpt, "model_and_var.yml"),
                                      "config_path_t": os.path.join(ckpt, "train.yml"),
                                      "checkpoint_path": os.path.join(ckpt, "params.msgpack"),
                                      "n_steps": 25, "n_steps_to_store": 2,
                                      **({"dtype": "bfloat16"} if dtype == "bf16" else {})}})
        if attention == "reference":  # masked_flash_attention -> _ref_attention (flash_shapes_ok patched)
            inf.model = JFlowModel(config=inf.config_mv["flow_model"], dtype=inf.dtype, attn_impl="flash")
        inf.run_pred({"truth_path": truth, "pred_path": pred, "entry_start": 0, "n_events": n_events,
                      "n_ensemble": 10, "ode_method": "ab2e", "save_ensemble_components": False,
                      "store_energy_incidence": False, "batch_size": batch_size, "max_particles": 1, "seed": 0})
        metrics = jcs.evaluate(truth, pred)
    metrics.update(generator=jcs.GEN, generator_seed=13, n_events=n_events, n_ensemble=10, ode_method="ab2e",
                   n_steps=25, dtype=dtype, attention=attention, batch_size=batch_size, platform="cpu",
                   jax=jax.__version__)
    with open(out_path, "w") as fp:
        json.dump(metrics, fp, indent=2)
    return metrics


def port_vs_jax_sr_reading(n_events, batch_size=16):
    """The SR closure reading on the first ``n_events`` of the suite's test
    events in fp32 on the CPU, by the JAX package and by the port fed the
    JAX package's noise (``fold_in(PRNGKey(0), batch)``, a key per member):
    the same function, so the same reading to the summation order.  Full
    width: about 20 minutes for 32 events on 8 CPU cores."""
    import tempfile

    import jax
    import jax.numpy as jnp

    from superresolutionhep_tpu.data.synthetic import GeneratorConfig as JGeneratorConfig
    from superresolutionhep_tpu.data.synthetic import write_synthetic_file as jwrite_synthetic_file
    from superresolutionhep_tpu.inference.sr import SRInference as JSRInference

    torch.set_num_threads(os.cpu_count())
    jcs = jax_script("closure_suite")
    ckpt = os.path.join(ROOT, "saved_checkpoints", "closure_sr")
    model = {"config_path_mv": os.path.join(ckpt, "model_and_var.yml"), "config_path_t": os.path.join(ckpt, "train.yml"),
             "checkpoint_path": os.path.join(ckpt, "params.msgpack"), "n_steps": 25, "n_steps_to_store": 2}
    item = {"entry_start": 0, "n_events": n_events, "n_ensemble": 10, "ode_method": "ab2e",
            "save_ensemble_components": False, "store_energy_incidence": False, "batch_size": batch_size,
            "max_particles": 1, "seed": 0}

    def noise(bi, shape):
        keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), bi), shape[0])
        return np.stack([np.asarray(jax.random.normal(k, shape[1:], jnp.float32)) for k in keys])

    with tempfile.TemporaryDirectory() as d:
        truth = jwrite_synthetic_file(os.path.join(d, "test.h5"), 256, seed=13, config=JGeneratorConfig(**jcs.GEN))
        JSRInference({"model": model}).run_pred(dict(item, truth_path=truth, pred_path=os.path.join(d, "jax.h5")))
        SRInference({"model": model}, device="cpu").run_pred(
            dict(item, truth_path=truth, pred_path=os.path.join(d, "port.h5")), noise=noise)
        return {"n_events": n_events, "jax": jcs.evaluate(truth, os.path.join(d, "jax.h5")),
                "port": cs.evaluate(truth, os.path.join(d, "port.h5"))}


if __name__ == "__main__":
    if sys.argv[1:3] in (["jax_sr_reading", "fp32"], ["jax_sr_reading", "bf16"]) and len(sys.argv) <= 4:
        dtype, attention = sys.argv[2], (sys.argv[3:] or [None])[0]  # attention: einsum | reference
        name = f"closure_sr_jax_{dtype}" + (f"_{attention}" if attention else "")
        print(json.dumps(jax_sr_reading(os.path.join(ROOT, "tests", "golden_torch", f"{name}.json"), dtype, attention),
                         indent=2))
    elif sys.argv[1:2] == ["port_vs_jax"] and len(sys.argv) == 3:
        print(json.dumps(port_vs_jax_sr_reading(int(sys.argv[2]))))
    else:
        raise SystemExit("usage: python tests/test_torch_port_closure.py jax_sr_reading fp32|bf16 [einsum|reference] "
                         "| port_vs_jax N")
