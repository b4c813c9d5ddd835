"""PyTorch port, the PF analysis class, the flop counter and the host
allocator tuning against the JAX package (CPU).

* ``analysis/performance.py::PFPerformanceCOCOA`` against the JAX class on
  the same files (the port's own SR and PF outputs of
  ``test_torch_port_closure.make_closure_files``, PF rows shuffled so that
  ``idx`` is out of order): every joined array, the cardinality confusion,
  the kinematic residuals, the incidence colours (soft, argmax, whitened)
  and the truth incidence, all exactly equal (the same numpy code on the
  same arrays); every plot method and the examples write their files
  (matplotlib's Agg backend).
* ``tools/flops.py`` against the JAX counter at the multipart configuration,
  bucketed and packed: the counts are sums of integers in float64, so equal;
  and against ``torch.utils.flop_counter.FlopCounterMode`` on the plain path
  within the few percent ``tests/test_flops.py`` allows against XLA (the
  analytic count leaves out elementwise work).
* ``utils/hostmem.py::ensure_tuned``: a no-op under pytest, and the argv it
  re-execs for a ``python -m`` invocation (``os.execv`` replaced)."""

import os
import sys

import jax
import jax.numpy as jnp
import matplotlib
import numpy as np
import pytest
import torch
import yaml

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from superresolutionhep_tpu.analysis import performance as jperf  # noqa: E402
from superresolutionhep_tpu.models.flow_model import FlowModel as JFlowModel  # noqa: E402
from superresolutionhep_tpu.tools import flops as jflops  # noqa: E402
from superresolutionhep_tpu_torch.analysis import PFPerformanceCOCOA, performance  # noqa: E402
from superresolutionhep_tpu_torch.models.flow_model import FlowModel  # noqa: E402
from superresolutionhep_tpu_torch.tools import flops  # noqa: E402
from superresolutionhep_tpu_torch.utils import hostmem  # noqa: E402

from test_torch_port_closure import make_closure_files  # noqa: E402

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOINED = ("truth_part_pt", "truth_part_eta", "truth_part_phi", "truth_part_e", "truth_part_dep_e",
          "low_part_pt", "low_part_eta", "low_part_phi", "low_part_e",
          "high_part_pt", "high_part_eta", "high_part_phi", "high_part_e",
          "inc_wt_lr_pf", "inc_wt_hr_pf", "truth_cardinality", "low_cardinality", "high_cardinality",
          "max_part", "pf_colors")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return make_closure_files(tmp_path_factory.mktemp("pf_analysis"))[0]


def _same(a, b, what=""):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b), what
        for k in b:
            _same(a[k], b[k], f"{what}/{k}")
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), what
        for x, y in zip(a, b):
            _same(x, y, what)
    elif b is None:
        assert a is None, what
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)


def _perf(mod, paths, shuffled=True):
    tag = "_shuffled" if shuffled else ""
    return mod.PFPerformanceCOCOA(paths["sr"], paths[f"pf_low{tag}"], paths[f"pf_high{tag}"], res_factor=2)


def test_pf_performance_matches_jax(files):
    """The join by ``idx`` of shuffled PF rows, and everything computed on
    it, equal to the JAX class; the in-order files give the same join."""
    mine, ref = _perf(performance, files), _perf(jperf, files)
    in_order = _perf(jperf, files, shuffled=False)
    for name in JOINED:
        _same(getattr(mine, name), getattr(ref, name), name)
        _same(getattr(in_order, name), getattr(ref, name), name)
    assert mine.n_events == ref.n_events == len(mine.truth_cardinality)
    _same(mine.cardinality_confusion(), ref.cardinality_confusion(), "confusion")
    _same(mine.kinematic_residuals(), ref.kinematic_residuals(), "residuals")
    seen = 0
    for ev in range(mine.n_events):
        for res in ("lr", "hr"):
            for kw in ({}, {"argmax": True}, {"threshold": 0.6}):
                got, want = mine.get_rgb(res, ev, **kw), ref.get_rgb(res, ev, **kw)
                _same(got, want, f"rgb {res} {ev} {kw}")
                seen += want is not None
        _same(mine.load_truth_incidence(files["truth"], ev), ref.load_truth_incidence(files["truth"], ev), "inc")
    assert seen > mine.n_events  # most events colour on both resolutions


def test_pf_plots_and_examples_write_files(files, tmp_path):
    """Every PF plot method writes its figure; the PF and the data
    examples run on the port's files (``performance_single_electron`` only
    chains the SR plotters, which tests/test_torch_port_live.py holds, and
    ``shipped_checkpoint_demo`` runs the full-width checkpoint)."""
    from superresolutionhep_tpu_torch.examples import data_inspection, performance_multipart_pf

    perf = PFPerformanceCOCOA(files["sr"], files["pf_low_shuffled"], files["pf_high_shuffled"], res_factor=2)
    ev = next(i for i in range(perf.n_events) if perf.get_rgb("lr", i) is not None
              and perf.get_rgb("hr", i) is not None)
    d = str(tmp_path)
    for fig in (perf.plot_pf_event_display(ev, dir=d), perf.plot_pf_event_display_v2(ev, dir=d),
                perf.plot_pf_event_display_old(ev, dir=d, verbose=True),
                perf.plot_pf_event_display_grid(range(3), dir=d),
                perf.plot_incidence_truth_vs_pred(ev, files["truth"], dir=d)):
        assert fig is not None
        plt.close(fig)
    for name in (f"ED_{ev}", f"ED_argmax_{ev}", f"ED_wide_{ev}", "ED_grid_hr", f"incidence_truth_vs_pred_{ev}"):
        assert os.path.getsize(os.path.join(d, f"{name}.png")) > 0, name

    performance_multipart_pf.main(["--sr", files["sr"], "--lr", files["pf_low_shuffled"], "--hr",
                                   files["pf_high_shuffled"], "-o", d, "--res_factor", "2", "--n_displays", "0"])
    data_inspection.main(["--file", files["truth"], "-o", d])
    plt.close("all")
    for name in ("confusion_lr.txt", "confusion_hr.txt", "data_inspection.png"):
        assert os.path.getsize(os.path.join(d, name)) > 0, name


def _jax_params(cfg, B=1, N=8):
    model = JFlowModel(config=cfg["flow_model"], attn_impl="einsum")
    batch = {"eta": jnp.zeros((B, N, 1)), "cosphi": jnp.ones((B, N, 1)), "sinphi": jnp.zeros((B, N, 1)),
             "layer": jnp.zeros((B, N, 1), jnp.int32), "e_proxy": jnp.zeros((B, N, 1)),
             "q_mask": jnp.ones((B, N), bool)}
    # the counter reads the kernels' shapes only: trace the init, run nothing
    return jax.eval_shape(model.init, jax.random.PRNGKey(0), batch, jnp.zeros((B, N, 1)), jnp.zeros((B,)))


def test_flop_counts_match_jax():
    """Every count of the port's counter, read from the port's model, equal
    to the JAX counter's read from the JAX parameter tree (multipart
    configuration): bucketed with and without padding, packed rows with
    alignment gaps at two blockings, the train step with and without remat,
    and the sampler evaluations."""
    with open(os.path.join(ROOT, "configs/multipart/model_and_var.yml")) as fp:
        cfg = yaml.safe_load(fp)
    params, model = _jax_params(cfg), FlowModel(cfg["flow_model"])
    for B, N, nv in ((2, 128, None), (3, 512, [500, 37, 129])):
        assert flops.flow_model_flops(model, cfg, B, N, nv) == jflops.flow_model_flops(params, cfg, B, N, nv)
        for remat in (True, False):
            assert (flops.train_step_flops(model, cfg, B, N, nv, remat=remat)
                    == jflops.train_step_flops(params, cfg, B, N, nv, remat=remat))
    seg = np.full((3, 2048), -1, np.int32)
    seg[0, :300], seg[0, 384:1500], seg[0, 1536:2000] = 0, 1, 2
    seg[1, :2048] = 0
    seg[2, :128] = 0  # mostly padding
    for bq, bk in ((128, 128), (512, 256)):
        got = flops.flow_model_flops_packed(model, cfg, seg, bq, bk)
        assert got == jflops.flow_model_flops_packed(params, cfg, seg, bq, bk), (bq, bk)
        assert got["attention"] > got["attention_masked"] > 0
    for method in ("euler", "midpoint", "heun", "rk4", "ab2", "ab3", "ab2e"):
        assert flops.sampler_evals(25, method) == jflops.sampler_evals(25, method)
    with pytest.raises(ValueError):
        flops.sampler_evals(25, "dopri5")


def test_flop_count_agrees_with_flop_counter_mode():
    """The analytic forward and no-recompute train-step counts against
    PyTorch's own count of the plain path's matmuls (forward, and forward +
    backward), within tests/test_flops.py's bounds against XLA."""
    from torch.utils.flop_counter import FlopCounterMode

    from superresolutionhep_tpu_torch.configs import MULTIPART_CONFIG_MV as cfg

    B, N = 2, 128
    model = FlowModel(cfg["flow_model"])
    g = torch.Generator().manual_seed(0)
    batch = {"eta": torch.rand(B, N, 1, generator=g), "cosphi": torch.rand(B, N, 1, generator=g),
             "sinphi": torch.rand(B, N, 1, generator=g), "layer": torch.randint(0, 3, (B, N, 1), generator=g),
             "e_proxy": torch.rand(B, N, 1, generator=g), "q_mask": torch.ones(B, N, dtype=torch.bool)}
    x, t = torch.randn(B, N, 1, generator=g), torch.rand(B, generator=g)
    with FlopCounterMode(display=False) as fwd:
        with torch.no_grad():
            model(batch, x, t)
    with FlopCounterMode(display=False) as step:
        model(batch, x, t).square().sum().backward()
    want = flops.flow_model_flops(model, cfg, B, N)["total"]
    assert 0.93 * fwd.get_total_flops() <= want <= 1.001 * fwd.get_total_flops()
    useful = flops.train_step_flops(model, cfg, B, N, remat=False)["total_useful"]
    assert 0.93 * step.get_total_flops() <= useful <= 1.001 * step.get_total_flops()


def test_ensure_tuned_noop_under_pytest_and_module_argv(monkeypatch):
    calls = []
    monkeypatch.setattr(hostmem.os, "execv", lambda exe, argv: calls.append((exe, argv)))
    for k in hostmem._VARS:  # set, then delete: monkeypatch restores the original state
        monkeypatch.setenv(k, "x")
        monkeypatch.delenv(k)
    module_path = os.path.join(ROOT, "superresolutionhep_tpu_torch", "cli", "train_sr.py")
    monkeypatch.setattr(sys, "argv", [module_path, "-cmv", "mv.yml"])
    monkeypatch.setattr(sys, "orig_argv", ["python3", "-X", "dev", "-m", "superresolutionhep_tpu_torch.cli.train_sr",
                                           "-cmv", "mv.yml"])
    hostmem.ensure_tuned()
    assert calls == [] and not any(k in os.environ for k in hostmem._VARS)  # pytest is loaded

    monkeypatch.delitem(sys.modules, "pytest")
    hostmem.ensure_tuned()
    assert calls == [(sys.executable, [sys.executable, "-X", "dev", "-m", "superresolutionhep_tpu_torch.cli.train_sr",
                                       "-cmv", "mv.yml"])]
    assert all(os.environ[k] == v for k, v in hostmem._VARS.items())
    hostmem.ensure_tuned()  # the tunables are set now: nothing more
    assert len(calls) == 1

    for k in hostmem._VARS:
        monkeypatch.delenv(k)
    monkeypatch.setattr(sys, "argv", ["-c"])
    monkeypatch.setattr(sys, "orig_argv", ["python3", "-c", "pass"])
    hostmem.ensure_tuned()  # -c cannot be reproduced
    assert len(calls) == 1 and hostmem.reexec_argv() is None
