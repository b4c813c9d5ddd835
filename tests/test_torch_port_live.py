"""PyTorch port, the live validation plots and the SR plotters against the JAX
package (``analysis/{util,performance,live}.py``), on the same arrays: the
summary helpers, the live accumulator fed one collated validation batch, the
offline ``PerformanceCOCOA`` reading an inference file through the port's
HDF5 reader, and ``SRTrainer.evaluate`` drawing the live plots on the CPU
(matplotlib's Agg backend).  Both sides are the same numpy code on the same
inputs: the summary numbers must be equal, not close."""

import os

import matplotlib
import numpy as np
import pytest
import torch

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from superresolutionhep_tpu.analysis import live as jlive  # noqa: E402
from superresolutionhep_tpu.analysis import performance as jperf  # noqa: E402
from superresolutionhep_tpu.analysis import util as jutil  # noqa: E402
from superresolutionhep_tpu_torch.analysis import live, performance, util  # noqa: E402
from superresolutionhep_tpu_torch.data import root_io  # noqa: E402
from superresolutionhep_tpu_torch.data.jagged import JaggedArray  # noqa: E402
from superresolutionhep_tpu_torch.data.sr_dataset import collate  # noqa: E402
from superresolutionhep_tpu_torch.train.sr_trainer import SRTrainer  # noqa: E402

from test_torch_port_train import make_configs, make_dataset  # noqa: E402

torch.set_num_threads(1)


def _same(a, b):
    if isinstance(a, dict):
        assert sorted(a, key=str) == sorted(b, key=str)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_summary_helpers_match_jax():
    rng = np.random.default_rng(0)
    arrays = [rng.normal(size=500), rng.exponential(size=77) * 1e3, np.array([2.0, 2.0, 2.0]),
              np.array([np.inf, 1.0, -2.0, np.nan, 5.0])]
    for a in arrays[:3]:
        assert util.mean_std_iqr(a) == jutil.mean_std_iqr(a)
        assert util.mean_std_iqr_label(a, 1) == jutil.mean_std_iqr_label(a, 1)
    for arrs in ([arrays[0], arrays[1]], [arrays[2]], [arrays[3]], [np.zeros(0)]):
        _same(util.robust_bins(*arrs), jutil.robust_bins(*arrs))
        _same(util.robust_bins(*arrs, n_bins=12, lo=5.0, hi=95.0), jutil.robust_bins(*arrs, n_bins=12, lo=5.0, hi=95.0))


def test_live_accumulator_matches_jax():
    """One collated validation batch (with LR cells and a filler row) and its
    predictions into both live accumulators: the stored rows, the layer
    sums, the residual summary scalars, the cell residual plot and an event
    display."""
    config_mv, _ = make_configs()
    ds = make_dataset(config_mv, 3, seed=7)
    hb = collate([ds.get_event(i) for i in range(3)] + [None], 128, with_low=True)
    e_pred_raw = hb["e_truth_raw"] * np.random.default_rng(1).uniform(0.7, 1.3, size=hb["e_truth_raw"].shape)
    accs = []
    for mod in (live, jlive):
        acc = mod.PerformanceCOCOALive(2)
        acc.update(hb, e_pred_raw.astype(np.float32))
        accs.append(acc)
    mine, ref = accs
    assert mine.n_events == ref.n_events == 3
    for name in ("low_phi", "low_layer", "low_eta", "low_e_measured", "high_phi", "high_layer", "high_eta",
                 "high_e_truth", "high_e_pred"):
        _same(getattr(mine, name), getattr(ref, name))
    _same(mine._layer_sums(), ref._layer_sums())
    (fig_a, summ_a), (fig_b, summ_b) = mine.plot_residual_event(), ref.plot_residual_event()
    assert set(summ_a) == {f"res_event/pred_{s}" for s in ("mean", "std", "iqr", "rel_mean", "rel_std", "rel_iqr")}
    _same(summ_a, summ_b)
    plt.close(fig_a), plt.close(fig_b)
    plt.close(mine.plot_residual_cell())
    m = hb["q_mask"][0]
    pl = {"eta_raw": hb["eta_raw"][0, m, 0], "phi": hb["phi"][0, m, 0], "layer": hb["layer"][0, m, 0],
          "target": hb["target"][0, m, 0], "e_truth_raw": hb["e_truth_raw"][0, m, 0],
          "pred": hb["target"][0, m, 0], "e_pred_raw": e_pred_raw[0, m, 0]}
    fig = live.event_display_figure(pl)
    assert len(fig.axes) >= 15
    plt.close(fig)


def test_performance_cocoa_reads_inference_file_like_jax(tmp_path):
    """An SR inference file with ensemble components and stored steps,
    written by the port's HDF5 writer, read by both classes: the same
    rows, ensemble averages, layer sums, residual summaries and ensemble-size
    widths."""
    rng = np.random.default_rng(2)
    n_ev, n_comp = 5, 3
    low, high = {}, {}
    low_n = rng.integers(5, 12, n_ev)
    high_n = low_n * 4

    def jag(ns, fn):
        return JaggedArray.from_list([fn(n).astype(np.float32) for n in ns])

    for tree, ns in ((low, low_n), (high, high_n)):
        tree["phi"] = jag(ns, lambda n: rng.uniform(-3, 3, n))
        tree["layer"] = jag(ns, lambda n: rng.integers(0, 3, n))
        tree["eta_raw"] = jag(ns, lambda n: rng.uniform(-2.5, 2.5, n))
    low["e_meas_raw"] = jag(low_n, lambda n: rng.exponential(50.0, n))
    for k in ("e_truth_raw", "e_pred_raw", "e_proxy_raw", "raw_nn_cond", "raw_nn_target", "raw_nn_pred",
              "e_pred_raw_t0.5", "raw_nn_pred_t0.5", *(f"e_pred_raw_comp_{c}" for c in range(n_comp))):
        high[k] = jag(high_n, lambda n: rng.exponential(20.0, n))
    path = str(tmp_path / "pred.h5")
    root_io.write_trees(path, {"Low_Tree": low, "High_Tree": high})

    mine, ref = performance.PerformanceCOCOA(path, 2), jperf.PerformanceCOCOA(path, 2)
    for name in ("low_e_measured", "high_e_truth", "high_e_pred", "high_e_pred_direct", "high_raw_nn_pred"):
        _same(getattr(mine, name), getattr(ref, name))
    _same(mine.high_e_pred_step, ref.high_e_pred_step)
    _same(mine.compute_ensemble_average(2), ref.compute_ensemble_average(2))
    _same(mine._layer_sums(), ref._layer_sums())
    _same(mine.plot_residual_event(truth_e_range=(10.0, 1e9))[1], ref.plot_residual_event(truth_e_range=(10.0, 1e9))[1])
    _same(mine.plot_ensemble_size_comparison(sizes=(1, 2, 3))[1], ref.plot_ensemble_size_comparison(sizes=(1, 2, 3))[1])
    assert mine.check_binning(0) == ref.check_binning(0)
    for fig in (mine.plot_evolution(0, dir=str(tmp_path)), mine.plot_residual_event_ens(dir=str(tmp_path))):
        plt.close(fig)
    plt.close("all")
    assert os.path.exists(tmp_path / "evolution_ev0.png") and os.path.exists(tmp_path / "residual_event_ensemble.png")


def test_sr_trainer_evaluate_draws_live_plots(tmp_path):
    """``n_event_displays: 2`` (as every shipped SR train config sets it):
    ``evaluate`` with the plots on draws two event displays of the first
    batch and both residual plots, and returns the residual summary scalars
    beside the losses; without plots it returns the losses only."""
    config_mv, config_t = make_configs(n_event_displays=2, val_ode_method="midpoint")
    tr = SRTrainer(config_mv, config_t, run_dir=str(tmp_path / "run"), device="cpu")
    ds = make_dataset(config_mv, 3, seed=9)
    out = tr.evaluate(ds, n_steps=3, make_plots=True)
    figs = sorted(os.listdir(tmp_path / "run" / "figures"))
    assert figs == ["ED_0_0.png", "ED_1_0.png", "residual_cell_energy_0.png", "residual_event_energy_0.png"]
    assert {"val/loss", "val/loss_raw", "res_event/pred_mean", "res_event/pred_rel_iqr"} <= set(out)
    assert all(np.isfinite(v) for v in out.values())
    assert set(tr.evaluate(ds, n_steps=3)) == {"val/loss", "val/loss_raw"}
    with pytest.raises(ValueError):
        performance.PerformanceCOCOA(str(tmp_path / "none.h5"), 3)
