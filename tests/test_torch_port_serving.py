"""PyTorch port, host data layer and the serving path against the JAX
package: synthetic events, the in-memory dataset and collate (exact), the
HDF5 container, ``SRServer.predict_event`` on the CPU at a small size with
the JAX server's own noise injected, the shipped config literals, and the
static rule that the port imports neither JAX nor the JAX package."""

import copy
import os
import re
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from superresolutionhep_tpu.data import synthetic as jsyn
from superresolutionhep_tpu.data.sr_dataset import SupResEvents as JSupResEvents
from superresolutionhep_tpu.data.sr_dataset import collate as jcollate
from superresolutionhep_tpu.inference.server import SRServer as JSRServer
from superresolutionhep_tpu_torch import configs
from superresolutionhep_tpu_torch.data import root_io
from superresolutionhep_tpu_torch.data import synthetic as tsyn
from superresolutionhep_tpu_torch.data.sr_dataset import MODEL_BATCH_KEYS, SupResEvents, collate
from superresolutionhep_tpu_torch.inference.server import (
    DEFAULT_BUCKETS, LOW_KEYS, EventTooLargeError, SRServer, _event_to_trees)
from superresolutionhep_tpu_torch.inference.sr import SRInference
from superresolutionhep_tpu_torch.tools import convert

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEN = dict(res_factor=2, single_electron=True, window_lr_cells=1)


def _tree_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        for attr in ("flat", "offsets", "inner_offsets", "outer_offsets"):
            if hasattr(a[k], attr):
                x, y = getattr(a[k], attr), getattr(b[k], attr)
                assert x.dtype == y.dtype and np.array_equal(x, y), (k, attr)


@pytest.mark.parametrize("kw", [GEN, dict(res_factor=4, max_particles=3, window_lr_cells=1),
                                dict(res_factor=2, collimate_delta_r_lr_cells=2.0, window_lr_cells=1)])
def test_generate_events_equal_to_jax_package(kw):
    ours = tsyn.generate_events(2, seed=4, config=tsyn.GeneratorConfig(**kw))
    theirs = jsyn.generate_events(2, seed=4, config=jsyn.GeneratorConfig(**kw))
    for tree in ("Low_Tree", "High_Tree"):
        _tree_equal(ours[tree], theirs[tree])


def _small_config_mv():
    mv = copy.deepcopy(configs.MULTIPART_CONFIG_MV)
    mv["res_factor"] = 2
    fm = mv["flow_model"]
    fm["h_dim"] = 128
    fm["feat_0_mlp"]["output_size"] = 128
    fm["transformer"]["num_transformer_layers"] = 2
    fm["transformer"]["dense_config"]["hidden_layers"] = [128]
    return mv


def test_dataset_and_collate_equal_to_jax_package(tmp_path):
    mv = _small_config_mv()
    path = str(tmp_path / "ev.h5")
    tsyn.write_synthetic_file(path, 3, seed=5, config=tsyn.GeneratorConfig(**GEN))
    ours = SupResEvents(path, mv, make_low=True, make_particles=True)
    theirs = JSupResEvents(path, mv, make_low=True, make_particles=True)  # the same container, both readers
    assert ours.cell_count_high == theirs.cell_count_high and len(ours) == 3
    evs, jevs = [ours.get_event(i) for i in range(3)], [theirs.get_event(i) for i in range(3)]
    for a, b in zip(evs, jevs):
        for part in ("high", "low", "particles"):
            da, db = getattr(a, part), getattr(b, part)
            assert set(da) == set(db)
            for k in da:
                assert da[k].dtype == db[k].dtype and np.array_equal(da[k], db[k]), (part, k)
        assert a.cond_params == b.cond_params and np.array_equal(a.high_e_part, b.high_e_part)
    hb, jhb = collate(evs + [None], 256, with_low=True), jcollate(jevs + [None], 256, with_low=True)
    assert set(hb) == set(jhb)
    for k in hb:
        if isinstance(hb[k], np.ndarray):
            assert hb[k].dtype == jhb[k].dtype and np.array_equal(hb[k], jhb[k]), k
    # in-memory constructor (the serving path) gives the same events
    low = root_io.read_tree(path, "Low_Tree")
    high = root_io.read_tree(path, "High_Tree")
    mem = SupResEvents.from_trees(low, high, mv).get_event(1)
    for k in mem.high:
        assert np.array_equal(mem.high[k], evs[1].high[k]), k
    assert root_io.num_entries(path, "Low_Tree") == 3
    with pytest.raises(RuntimeError):
        root_io.read_tree(str(tmp_path / "ev.root"), "Low_Tree")


def _request(trees, i):
    low, high = trees["Low_Tree"], trees["High_Tree"]
    ev = {"low": {k: np.asarray(low[k][i]).tolist() for k in LOW_KEYS},
          "high": {k: np.asarray(high[k][i]).tolist() for k in LOW_KEYS if k != "cell_e"}}
    ev["low"]["high_cell_to_low_cell_edge"] = np.asarray(low["high_cell_to_low_cell_edge"][i]).tolist()
    return ev


def _jax_noise(counter, shape):
    """x0 as the JAX server's sampler draws it for request number `counter`."""
    keys = jax.random.split(jax.random.PRNGKey(counter), shape[0])
    return np.stack([np.asarray(jax.random.normal(k, shape[1:], jnp.float32)) for k in keys])


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve")
    mv = _small_config_mv()
    mv_path, t_path = str(d / "mv.yml"), str(d / "t.yml")
    yaml.safe_dump(mv, open(mv_path, "w"))
    yaml.safe_dump(configs.MULTIPART_CONFIG_T, open(t_path, "w"))
    tree = convert.init_params_jax_layout(mv["flow_model"], seed=2)
    model_cfg = {"n_steps": 3, "n_steps_to_store": 1, "fast_softmax": True, "fused_prologue": True}
    jsrv = JSRServer(
        {"model": dict(model_cfg, config_path_mv=mv_path, config_path_t=t_path, checkpoint_path=None),
         "n_ensemble": 2, "ode_method": "ab2e"},
        buckets=(256,), params=jax.tree_util.tree_map(jnp.asarray, tree))
    srv = SRServer(
        {"model": dict(model_cfg, config_mv=mv, config_t=configs.MULTIPART_CONFIG_T, checkpoint_path=None),
         "n_ensemble": 2, "ode_method": "ab2e"},
        buckets=(256,), params=convert.params_from_jax(tree, mv["flow_model"]), device="cpu", noise_fn=_jax_noise)
    trees = tsyn.generate_events(3, seed=9, config=tsyn.GeneratorConfig(**GEN))
    return srv, jsrv, trees


def test_predict_event_matches_jax_server(servers):
    """Same event, same weights, the JAX server's own noise: the port's CPU
    server (plain versions of the kernels, fused path, no-max softmax behind
    its first-batch gate) against the JAX server with its Pallas kernels in
    interpret mode.  1e-3 of the prediction's scale."""
    srv, jsrv, trees = servers
    ev = _request(trees, 0)
    want = jsrv.predict_event(ev)
    got = srv.predict_event(ev)
    assert got["n_cells"] == want["n_cells"] > 0 and got["bucket"] == want["bucket"] == 256
    assert got["batched_with"] == 1 and got["device_ms"] > 0
    for k in ("eta", "phi", "layer"):
        assert got[k] == want[k]
    a, b = np.asarray(got["e_pred_raw"]), np.asarray(want["e_pred_raw"])
    assert np.isfinite(a).all() and a.min() >= 0.0
    assert np.abs(a - b).max() <= 1e-3 * np.abs(b).max()
    assert srv.inf._nomax_validated and srv.inf.nomax_selfcheck_passed and srv.inf.fast_softmax
    assert jsrv.inf.fast_softmax  # both packages passed their first-batch gate


def test_concurrent_requests_share_one_sampler_call(servers):
    """Two requests queued for one bucket while the worker is busy run as ONE
    group (batched_with == 2), each getting its own event's answer."""
    srv, _, trees = servers
    srv.predict_event(_request(trees, 0))  # past the first-batch gate
    alone = [srv.predict_event(_request(trees, i)) for i in (1, 2)]
    out, errs = {}, []

    def call(i):
        try:
            out[i] = srv.predict_event(_request(trees, i))
        except Exception as e:  # surfaced by the assert below
            errs.append(e)

    # Hold the device lock; request 0 is taken by the worker, which then waits
    # for the lock inside _run_group; requests 1 and 2 queue up behind it and
    # must leave the queue together.
    entered, orig = threading.Event(), srv._run_group
    srv._run_group = lambda group: (entered.set(), orig(group))[1]
    try:
        with srv._lock:
            first = threading.Thread(target=call, args=(0,))
            first.start()
            assert entered.wait(timeout=60)
            threads = [threading.Thread(target=call, args=(i,)) for i in (1, 2)]
            for th in threads:
                th.start()
            for _ in range(6000):
                with srv._cond:
                    if len(srv._queue) == 2 or errs:
                        break
                threading.Event().wait(0.005)
            with srv._cond:
                assert len(srv._queue) == 2
        for th in [first, *threads]:
            th.join(timeout=120)
    finally:
        srv._run_group = orig
    assert not errs and set(out) == {0, 1, 2}
    assert out[0]["batched_with"] == 1 and out[1]["batched_with"] == 2 and out[2]["batched_with"] == 2
    assert out[1]["device_ms"] == out[2]["device_ms"]  # one sampler call
    for i, ref in zip((1, 2), alone):
        assert out[i]["n_cells"] == ref["n_cells"] and out[i]["eta"] == ref["eta"]
        assert np.isfinite(out[i]["e_pred_raw"]).all()


def test_server_bucketing_and_errors(servers):
    srv, _, trees = servers
    assert srv._bucket(1) == 256 and srv._bucket(256) == 256
    with pytest.raises(EventTooLargeError) as ei:
        srv._bucket(257)
    assert ei.value.n == 257 and ei.value.max_cells == 256
    assert DEFAULT_BUCKETS == (256, 512, 1024, 2048, 3072, 4096, 5120)
    with pytest.raises(KeyError):
        srv.predict_event({})  # malformed request: raised in the caller's thread
    low, high = _event_to_trees(_request(trees, 0))
    assert np.all(high["cell_e"][0] == 0.0) and len(low["cell_eta"]) == 1  # truth unknown at serving time
    srv.warmup()  # runs every bucket once; leaves the no-max gate to real requests


def test_http_round_trip(servers):
    """/health, /predict, a malformed request (400) and an oversize event (413)
    over the stdlib HTTP front end on localhost."""
    import json
    import socket
    import time
    import urllib.error
    import urllib.request

    srv, _, trees = servers
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    threading.Thread(target=srv.serve, kwargs={"port": port}, daemon=True).start()
    base = f"http://127.0.0.1:{port}"
    deadline = time.time() + 20
    while True:
        try:
            with urllib.request.urlopen(f"{base}/health", timeout=2) as r:
                assert json.load(r) == {"ok": True, "buckets": [256]}
            break
        except (urllib.error.URLError, ConnectionError):
            assert time.time() < deadline, "server did not come up"
            time.sleep(0.05)

    def post(payload):
        req = urllib.request.Request(f"{base}/predict", data=json.dumps(payload).encode(),
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.load(r)
        except urllib.error.HTTPError as e:
            return e.code, json.load(e)

    code, out = post(_request(trees, 1))
    assert code == 200 and out["n_cells"] == len(out["e_pred_raw"]) and out["total_ms"] > 0
    code, out = post({})
    assert code == 400 and "error" in out
    big = _request(tsyn.generate_events(1, seed=1, config=tsyn.GeneratorConfig(res_factor=2, max_particles=4,
                                                                              min_particles=4, window_lr_cells=2)), 0)
    code, out = post(big)
    assert code == 413 and out["max_cells"] == 256 and out["n_cells"] > 256


def test_cuda_entry_points_raise_without_a_card():
    """Entry points default to cuda and do not carry on on the CPU."""
    if torch.cuda.is_available():  # decided inside the test, never at import
        pytest.skip("this case describes a machine without a CUDA device")
    cfg = configs.serve_inference_config()
    with pytest.raises(RuntimeError, match="cuda"):
        SRServer(cfg, params={})
    with pytest.raises(RuntimeError, match="cuda"):
        SRInference(cfg, params={}, device="cuda")


def test_sr_inference_setup_and_fill_event():
    mv = _small_config_mv()
    tree = convert.init_params_jax_layout(mv["flow_model"], seed=2)
    inf = SRInference(
        {"model": {"config_mv": mv, "config_t": {}, "n_steps": 5, "n_steps_to_store": 2, "dtype": "bfloat16",
                   "fast_softmax": True}},
        params=convert.params_from_jax(tree, mv["flow_model"]), device="cpu")
    assert inf.store_set == [0, 2, 4] and inf.ts_to_store == [0.0, 0.5]
    assert inf.model.dtype == torch.bfloat16 and inf.model.etaphi_emb_net.linears[0].weight.dtype == torch.float32
    # the fast model shares the robust model's tensors
    assert inf.model_fast.feat_0_mlp.linears[0].weight.data_ptr() == inf.model.feat_0_mlp.linears[0].weight.data_ptr()
    trees = tsyn.generate_events(1, seed=3, config=tsyn.GeneratorConfig(**GEN))
    ev = SupResEvents.from_trees(
        {k: v.to_list() if hasattr(v, "to_list") else [v[0]] for k, v in trees["Low_Tree"].items()},
        {k: v.to_list() if hasattr(v, "to_list") else [v[0]] for k, v in trees["High_Tree"].items()},
        mv, make_low=True, make_particles=True).get_event(0)
    n = len(ev.high["eta"])
    traj = np.random.default_rng(0).normal(size=(2, 3, 256)).astype(np.float32)
    low_z, high_z, part_z = (dict() for _ in range(3))

    class _Lists(dict):
        def __missing__(self, k):
            self[k] = []
            return self[k]

    low_z, high_z, part_z = _Lists(), _Lists(), _Lists()
    inf._fill_event(ev, traj, low_z, high_z, part_z, n_ensemble=2, store_comp=True, store_inc=False, max_particles=0)
    tt = inf.target_transform
    want = np.stack([tt.inverse(traj[e, 2, :n], ev.high["e_proxy_raw"]) for e in range(2)]).mean(0) * 1e3
    np.testing.assert_allclose(high_z["e_pred_raw"][0], want, rtol=1e-6)
    assert "e_pred_raw_0.50_comp_1" in high_z and len(high_z["raw_nn_pred"][0]) == n
    assert inf.get_output_path({"truth_path": "/x/ev.h5", "dir_flag": None}).endswith("ev_pred.h5") is True


def test_config_literals_equal_the_yaml_files():
    with open(os.path.join(ROOT, "configs", "multipart", "model_and_var.yml")) as f:
        assert configs.MULTIPART_CONFIG_MV == yaml.safe_load(f)
    with open(os.path.join(ROOT, "configs", "multipart", "train.yml")) as f:
        assert configs.MULTIPART_CONFIG_T == yaml.safe_load(f)
    cfg = configs.serve_inference_config()
    assert cfg["n_ensemble"] == 10 and cfg["ode_method"] == "ab2e"
    assert cfg["model"]["n_steps"] == 25 and cfg["model"]["dtype"] == "bfloat16"
    assert cfg["model"]["fast_softmax"] and cfg["model"]["fused_prologue"]
    assert configs.serve_inference_config(fast_softmax=False)["model"]["fast_softmax"] is False
    assert set(MODEL_BATCH_KEYS) == {"eta", "cosphi", "sinphi", "layer", "e_proxy", "q_mask", "target"}


def _port_sources():
    pkg = os.path.join(ROOT, "superresolutionhep_tpu_torch")
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(pkg):
        files += [os.path.join(d, n) for n in names if n.endswith((".py", ".cu", ".cuh"))]
    return files


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_sources()
    assert len(files) > 25
    bad = re.compile(r"^\s*(import|from)\s+(jax|flax)\b|superresolutionhep_tpu\.|superresolutionhep_tpu\s+import", re.M)
    for path in files:
        text = open(path).read()
        hits = [m.group(0) for m in bad.finditer(text)]
        assert not hits, (path, hits)
    # chip_smoke.py must not need a YAML, HDF5 or msgpack parser either
    smoke = open(os.path.join(ROOT, "chip_smoke.py")).read()
    assert not re.search(r"^\s*(import|from)\s+(yaml|h5py|msgpack)\b", smoke, re.M)


def test_port_package_imports_without_jax_loaded():
    """A fresh interpreter imports every module of the port and none of
    jax / flax / the JAX package ends up in sys.modules."""
    import subprocess
    import sys

    code = (
        "import sys, importlib, pkgutil\n"
        "import superresolutionhep_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'superresolutionhep_tpu', 'triton')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-2000:]
