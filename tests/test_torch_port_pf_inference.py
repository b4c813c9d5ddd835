"""PyTorch port, stage-2 data and inference against the JAX package (fp32,
CPU): ``PflowEvents`` read from chunked files (and built in memory with
``from_trees``) and ``collate_pf`` give the JAX package's batches; the trees
``PFInference.run_pred`` writes equal the JAX package's on the same weights
(the published slot type, and random slots with the JAX draws through the
``noise(batch_index, shape)`` hook); the two CLIs chain (train, then infer
from the written checkpoint); without a card every entry point asked for
``cuda`` raises.

Tolerances: batches and cardinalities equal; predicted kinematics in raw
space and incidence weights 1e-4 relative + 1e-5 absolute (fp32 model on both
sides, another summation order, then the inverse transforms)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from superresolutionhep_tpu.data import root_io as jroot_io
from superresolutionhep_tpu.data.jagged import JaggedArray as JJagged
from superresolutionhep_tpu.data.pf_dataset import PflowEvents as JPflowEvents
from superresolutionhep_tpu.data.pf_dataset import collate_pf as jcollate_pf
from superresolutionhep_tpu.inference.pf import PFInference as JPFInference
from superresolutionhep_tpu_torch.data import root_io
from superresolutionhep_tpu_torch.data.pf_dataset import PflowEvents, collate_pf
from superresolutionhep_tpu_torch.inference.pf import PFInference
from superresolutionhep_tpu_torch.tools.convert import pf_params_from_jax
from superresolutionhep_tpu_torch.train.checkpoint import load_params

from test_torch_port_pf_model import jax_sapf, make_pf_batch, make_pf_trees, small_pf_config

torch.set_num_threads(1)
CFG_T = {"loss_on_inc_wts": True, "energy_threshold": 1.0, "resolution": "low", "bucket_quantum": 64,
         "card_loss_weight": 0.5}


def write_chunks(d, trees, cuts=((0, 4), (4, 7))):
    """The trees as stage-1 output chunks ``x_pred_{start}_{stop}.h5``."""
    for a, b in cuts:
        jroot_io.write_trees(str(d / f"x_pred_{a}_{b}.h5"), {
            name: {k: JJagged.from_list([np.asarray(x) for x in v[a:b]]) for k, v in tree.items()}
            for name, tree in trees.items()})
    return str(d / "x_pred_*_*.h5")


def write_configs(d, cfg, cfg_t):
    paths = (str(d / "config_mv.yml"), str(d / "config_t.yml"))
    for p, c in zip(paths, (cfg, cfg_t)):
        with open(p, "w") as fp:
            yaml.safe_dump(c, fp)
    return paths


def test_pf_dataset_and_collate_match_jax(tmp_path):
    cfg = small_pf_config()
    trees = make_pf_trees(7, seed=51)
    glob_arg = write_chunks(tmp_path, trees)
    for kw in (dict(res="low", load_incidence=True), dict(res="high", load_incidence=True, reduce_ds=5),
               dict(res="low", drop_single_part_events=True)):
        kw = dict(kw, energy_threshold=1.0)
        want = JPflowEvents(glob_arg, cfg, **kw)
        got = PflowEvents(glob_arg, cfg, **kw)
        mem = PflowEvents.from_trees(trees, cfg, **kw)
        assert len(want) == len(got) == len(mem) > 0 and want.cell_count == got.cell_count == mem.cell_count
        events = [[ds.get_event(i) for i in range(len(ds))] + [None] for ds in (want, got, mem)]
        batches = [f(ev, 192, 4) for f, ev in zip((jcollate_pf, collate_pf, collate_pf), events)]
        for b in batches[1:]:
            assert sorted(b) == sorted(batches[0])
            for k, v in batches[0].items():
                assert b[k].dtype == v.dtype and np.array_equal(b[k], v), k


def _read(path):
    return root_io.read_tree(path, "Particle_Tree")


@pytest.mark.parametrize("slots", ["embedding", "random"])
def test_run_pred_trees_match_jax(tmp_path, slots):
    cfg = small_pf_config(slots)
    glob_arg = write_chunks(tmp_path, make_pf_trees(7, seed=52))
    _, params = jax_sapf(cfg, make_pf_batch(53), seed=5)
    mv_path, t_path = write_configs(tmp_path, cfg, CFG_T)
    inf_cfg = {"model": {"config_path_mv": mv_path, "config_path_t": t_path, "checkpoint_path": None},
               "batch_size": 4}
    item = {"glob_arg": glob_arg, "store_inc_wt": True}
    JPFInference(inf_cfg, params=params).run_pred(dict(item, pred_path=str(tmp_path / "jax.h5")))

    def noise(bi, shape):  # the JAX run_pred's draws: fold_in(PRNGKey(0), bi)
        return np.array(jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(0), bi), shape, jnp.float32))

    PFInference(inf_cfg, params=pf_params_from_jax(params, cfg["pf_model"]), device="cpu").run_pred(
        dict(item, pred_path=str(tmp_path / "port.h5")), noise=noise)
    want, got = _read(str(tmp_path / "jax.h5")), _read(str(tmp_path / "port.h5"))
    assert sorted(got) == sorted(want) and any(k.startswith("pred_inc_wt_") for k in got)
    for k in ("truth_card", "pred_card", "idx"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]))
    for k in want:
        if k in ("truth_card", "pred_card", "idx"):
            continue
        for a, b in zip(got[k], want[k]):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-5, err_msg=k)


def test_cli_train_then_infer(tmp_path):
    """``cli.train_pf`` trains one epoch on the chunk files and checkpoints;
    ``cli.inference_pf`` predicts from that checkpoint, equal to
    ``PFInference.predict`` with the same parameters."""
    from superresolutionhep_tpu_torch.cli import inference_pf, train_pf

    cfg = small_pf_config()
    glob_arg = write_chunks(tmp_path, make_pf_trees(7, seed=54))
    cfg_t = dict(CFG_T, num_epochs=1, batch_size_train=4, batch_size_val=4, learningrate=1e-3, lr_scheduler=None,
                 train_glob_arg=glob_arg, val_glob_arg=glob_arg, num_workers=0, epoch_end_plots=False)
    mv_path, t_path = write_configs(tmp_path, cfg, cfg_t)
    run = str(tmp_path / "run")
    tr = train_pf.main(["-cmv", mv_path, "-ct", t_path, "--run_dir", run, "--device", "cpu"])
    assert tr.epoch == 1
    inf_path = str(tmp_path / "inference_pf.yml")
    with open(inf_path, "w") as fp:
        yaml.safe_dump({"model": {"config_path_mv": mv_path, "config_path_t": t_path,
                                  "checkpoint_path": f"{run}/checkpoints"}, "batch_size": 4,
                        "items": [{"run_pred": True, "glob_arg": glob_arg, "pred_file_name": "pf_pred.h5"},
                                  {"run_pred": False, "glob_arg": glob_arg, "pred_file_name": "skipped.h5"}]}, fp)
    inf = inference_pf.main(["-i", inf_path, "--device", "cpu"])
    out = os.path.join(os.path.dirname(mv_path), "inference")
    assert os.listdir(out) == ["pf_pred.h5"]
    got = _read(os.path.join(out, "pf_pred.h5"))
    ref = PFInference(inf.inf_cfg, params=load_params(f"{run}/checkpoints"), device="cpu")
    want = ref.predict(ref.dataset(glob_arg), {})["Particle_Tree"]
    assert sorted(got) == sorted(want)
    for k in want:
        for a, b in zip(got[k], want[k]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_entry_points_refuse_cuda_without_card(tmp_path):
    """No card here: every stage-2 entry point and both probe scripts raise
    when asked for ``cuda`` (the default), instead of running on the CPU."""
    from superresolutionhep_tpu_torch.cli import inference_pf, train_pf
    from superresolutionhep_tpu_torch.scripts import kernel_experiments, probe_exp_dtype
    from superresolutionhep_tpu_torch.train.pf_trainer import PFTrainer

    assert not torch.cuda.is_available()
    cfg = small_pf_config()
    mv_path, t_path = write_configs(tmp_path, cfg, dict(CFG_T, num_epochs=1, train_glob_arg="none_*.h5"))
    inf_path = str(tmp_path / "inf.yml")
    with open(inf_path, "w") as fp:
        yaml.safe_dump({"model": {"config_path_mv": mv_path, "config_path_t": t_path, "checkpoint_path": "none"},
                        "items": []}, fp)
    calls = [
        lambda: PFInference({"model": {"config_mv": cfg, "config_t": CFG_T}}, params={}),
        lambda: PFTrainer(cfg, CFG_T, run_dir=str(tmp_path / "r")),
        lambda: train_pf.main(["-cmv", mv_path, "-ct", t_path, "--run_dir", str(tmp_path / "r2")]),
        lambda: inference_pf.main(["-i", inf_path]),
        lambda: kernel_experiments.main([]),
        lambda: probe_exp_dtype.main([]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="cuda"):
            call()
