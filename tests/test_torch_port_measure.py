"""PyTorch port, the measuring tools (``superresolutionhep_tpu_torch/tools/
{trace_summary,profile_inference}.py`` and the six measuring scripts) against
the JAX package's tools on the CPU, at their tiny sizes:

* ``trace_summary`` on a Chrome trace written here: the port's kernel names,
  a cuBLAS product, an elementwise kernel, a Memcpy, an overlap on a second
  stream; exact per-class sums, spans and busy shares; every ``__global__``
  entry point of ``csrc/`` classified; one name left out of the table moves
  its events out of the class;
* ``measure_serving_latency.synth_event`` equal to the JAX script's, array for
  array, and a tiny ``SRServer`` answering it (the JAX ``test_server.py``
  contract test); the tool's table on that server, its sampler-call count
  equal to the calls the server made;
* ``bench_packed_kernel``'s pair accounting equal to the JAX package's
  ``pack_events`` and ``band_ranges`` and the JAX script's bucket loop;
* ``profile_inference`` and ``probe_layout_copies`` end to end with
  ``--device cpu``, their flop fields equal to the JAX ``tools/flops.py``;
* ``bench_packed_train`` with ``--device cpu`` on 8 events: each leg trains
  each event once, the losses finite;
* every tool that runs on a device refuses ``--device cuda`` without a card.
"""

import glob
import importlib.util
import json
import os
import re
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolutionhep_tpu.data.packing import pack_events as jpack_events
from superresolutionhep_tpu.models.flow_model import FlowModel as JFlowModel
from superresolutionhep_tpu.ops.flash_packed import band_ranges as jband_ranges
from superresolutionhep_tpu.tools import flops as jflops
from superresolutionhep_tpu_torch.configs import serve_inference_config
from superresolutionhep_tpu_torch.inference.server import LOW_KEYS
from superresolutionhep_tpu_torch.ops.flash_packed import PACKED_DEFAULTS
from superresolutionhep_tpu_torch.scripts import (bench_kernel, bench_packed_kernel, bench_packed_train, common,
                                                  measure_serving_latency, probe_dispatch, probe_layout_copies)
from superresolutionhep_tpu_torch.tools import profile_inference, trace_summary

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _x(name, ts, dur, stream=7, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": stream, "ts": ts, "dur": dur,
            "args": {"device": 0, "stream": stream}}


def test_trace_summary_on_a_chrome_trace(tmp_path):
    k1 = "void flash_fwd_wgmma_kernel<64, false, false, 3>(CUtensorMap_st, CUtensorMap_st, int, int, int)"
    k7 = "void flash_fwd_wgmma_kernel<64, true, true, 3>(CUtensorMap_st, CUtensorMap_st, int, int, int)"
    k5 = "void flash_bwd_dq_f32_kernel<16, false>(float const*, float const*, int)"
    band = "packed_band_kernel(int const*, int*, int, int, int)"
    gemm = "nvjet_tst_128x64_64x8_1x2_h_bz_TNT"
    elem = ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, "
            "std::array<char*, 3ul> >(int, at::native::CUDAFunctor_add<float>, std::array<char*, 3ul>)")
    copy = ("void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl_nocast<"
            "at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}> >(int)")
    events = [
        # stream 7: 0-10 K1, 10-15 gemm, 20-26 elementwise, 26-30 copy, 40-50 K7 (no-max, packed)
        _x(k1, 0.0, 10.0), _x(gemm, 10.0, 5.0), _x(elem, 20.0, 6.0), _x(copy, 26.0, 4.0), _x(k7, 40.0, 10.0),
        # stream 9: a Memcpy overlapping stream 7's K1, then K5 and the band table
        _x("Memcpy HtoD (Pageable -> Device)", 5.0, 10.0, stream=9, cat="gpu_memcpy"),
        _x(k5, 12.0, 8.0, stream=9), _x(band, 30.0, 2.0, stream=9),
        # not device activity: host ops, runtime calls, a user annotation on the device line
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 1, "tid": 1, "ts": 0.0, "dur": 100.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "pid": 1, "tid": 1, "ts": 1.0, "dur": 2.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "step", "pid": 0, "tid": 7, "ts": 0.0, "dur": 60.0},
        {"ph": "f", "cat": "ac2g", "name": "flow", "id": 3, "pid": 0, "tid": 7, "ts": 0.0},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    (read, s), = trace_summary.main([str(tmp_path), "--top", "3"])
    assert read == str(path)

    assert s["events"] == 8 and s["kernel_us"] == 55.0
    assert s["span_us"] == 50.0 and s["busy_us"] == 42.0  # the union over both streams: 0-32 and 40-50
    assert s["busy_share"] == 42.0 / 50.0
    by_stream = {st["stream"]: st for st in s["streams"]}
    assert by_stream[7] == {"device": 0, "stream": 7, "events": 5, "span_us": 50.0, "kernel_us": 35.0,
                            "busy_us": 35.0, "busy_share": 0.7}
    assert by_stream[9]["span_us"] == 27.0 and by_stream[9]["kernel_us"] == 20.0
    assert by_stream[9]["busy_us"] == 17.0 and by_stream[9]["busy_share"] == 17.0 / 27.0  # 5-15 and 12-20 overlap
    assert {c: v["us"] for c, v in s["classes"].items() if v["us"]} == {
        "hand-kernel": 30.0, "gemm": 5.0, "elementwise/reduce": 6.0, "copy/layout": 14.0}
    assert abs(sum(v["share"] for v in s["classes"].values()) - 1.0) <= 1e-12
    assert s["hand_kernels"] == {"flash_fwd": 1, "packed_fwd_nomax": 1, "flash_bwd_dq": 1, "packed_band": 1}
    assert [t["name"] for t in s["top"]] == [k1, k7, "Memcpy HtoD (Pageable -> Device)"]

    # every __global__ entry point of the sources is named in the table
    src = "".join(open(p).read() for p in glob.glob(os.path.join(ROOT, "superresolutionhep_tpu_torch", "csrc", "*.cu")))
    entries = set(re.findall(r"__global__\s+void\b[^;{]*?\b(\w+_kernel)\s*\(", src))
    assert src.count("__global__") == len(entries) and entries == set(trace_summary.HAND_KERNELS)
    # the control: one entry point out of the table, its events leave the class
    table = {k: v for k, v in trace_summary.HAND_KERNELS.items() if k != "flash_fwd_wgmma_kernel"}
    evs = trace_summary.load_trace(str(path))
    assert trace_summary.hand_kernel_counts(evs, table) == {"flash_bwd_dq": 1, "packed_band": 1}
    assert trace_summary.summarize(evs, table=table)["classes"]["hand-kernel"]["us"] == 10.0


def test_synth_event_equals_the_jax_script_and_a_server_answers_it():
    jmod = _load_jax_script("measure_serving_latency")
    for n, seed, rf in ((150, 3, 2), (1900, 7, 4), (1, 0, 4)):
        ours, theirs = measure_serving_latency.synth_event(n, seed, rf), jmod.synth_event(n, seed=seed, res_factor=rf)
        assert ours == theirs

    cfg = serve_inference_config(common.tiny_config_mv(), n_steps=3)
    cfg["n_ensemble"] = 2
    server = measure_serving_latency.make_server(torch.device("cpu"), cfg, buckets=(256,))
    ev = measure_serving_latency.synth_event(150, seed=3)
    assert set(LOW_KEYS) <= set(ev["low"])
    assert set(k for k in LOW_KEYS if k != "cell_e") <= set(ev["high"])
    n_hr = len(ev["high"]["cell_eta"])
    assert sorted(ev["low"]["high_cell_to_low_cell_edge"]) == list(range(n_hr))
    assert n_hr == len(ev["low"]["cell_eta"]) * 16  # rf^2 children per LR cell
    out = server.predict_event(ev)
    assert out["n_cells"] == n_hr and out["bucket"] == 256
    assert len(out["e_pred_raw"]) == n_hr and np.isfinite(out["e_pred_raw"]).all()

    # the tool's table on this server; its count of sampler calls is the server's
    calls, gen = [0], server.inf._gen
    lock = threading.Lock()

    def counted(*a, **kw):
        with lock:
            calls[0] += 1
        return gen(*a, **kw)

    server.inf._gen = counted
    table = measure_serving_latency.measure(server, reps=3, concurrency=2, sizes=[150],
                                            concurrent=((160, 7), (150, 11)))
    assert calls[0] == table["warmup_sampler_calls"] + table["sampler_calls"]
    assert table["buckets"]["150"]["bucket"] == 256 and table["first_request"]["selfcheck_passed"]
    for leg in (*table["buckets"].values(), table["concurrent"], table["concurrent_small"]):
        assert leg["p50_ms"] <= leg["p95_ms"]


def test_bench_packed_kernel_accounting_equals_the_jax_package():
    counts = bench_packed_kernel.event_counts()
    assert np.array_equal(counts, np.random.default_rng(42).integers(1200, 4801, 256))  # the JAX script's draw
    S, rows = 5120, 12
    squares = tuple((b, b) for b in bench_packed_kernel.JAX_BLOCKS) + ((64, 64),)
    acc = bench_packed_kernel.accounting(counts, S, rows, squares)
    assert acc["true_pairs"] == float((counts.astype(np.float64) ** 2).sum())

    layouts = bench_packed_kernel.pack_events(counts, S=S, rows_per_batch=rows)
    jlayouts = jpack_events(counts, S=S, rows_per_batch=rows)
    assert [lay.rows for lay in layouts] == [lay.rows for lay in jlayouts]
    segs = bench_packed_kernel.segment_ids(layouts, S)
    for blk_q, blk_k in squares:
        want = 0.0
        for seg in segs:  # the JAX script's executed pairs: sum(kc) * blk * blk
            _, kc = jband_ranges(jnp.asarray(seg), blk_q, blk_k)
            want += float(np.asarray(kc, np.float64).sum()) * blk_q * blk_k
        assert acc["band_exec_pairs"][(blk_q, blk_k)] == want, (blk_q, blk_k)

    pad = (-(-counts // 512) * 512).astype(int)  # the JAX script's bucket loop
    want = 0.0
    for L in sorted(set(pad)):
        idxs = np.nonzero(pad == L)[0]
        bs = max(1, min(64, (64 * 1536) // L))
        for s in range(0, len(idxs), bs):
            want += float(len(idxs[s: s + bs])) * L * L
    assert acc["bucket_exec_pairs"] == want


def _jax_flops(cfg, B, N):
    model = JFlowModel(config=cfg["flow_model"], attn_impl="einsum")
    batch = {"eta": jnp.zeros((1, 8, 1)), "cosphi": jnp.ones((1, 8, 1)), "sinphi": jnp.zeros((1, 8, 1)),
             "layer": jnp.zeros((1, 8, 1), jnp.int32), "e_proxy": jnp.zeros((1, 8, 1)),
             "q_mask": jnp.ones((1, 8), bool)}
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0), batch, jnp.zeros((1, 8, 1)), jnp.zeros((1,)))
    return jflops.flow_model_flops(params, cfg, B, N)


def test_profile_inference_and_probe_layout_copies_on_the_cpu(tmp_path):
    out = tmp_path / "profile.json"
    res = profile_inference.main(["--device", "cpu", "--reps", "1", "--out", str(out)])
    assert json.loads(out.read_text())["shapes"] == res["shapes"]
    (B, L), = profile_inference.TINY["shapes"]
    f = _jax_flops(common.tiny_config_mv(), B, L)
    for variant in ("robust", "fast"):
        r = res["shapes"][f"{B}x{L}"][variant]
        assert r["flops_per_eval_attention"] == f["attention"] and r["flops_per_eval_total"] == f["total"]
        assert r["finite"] and r["model_eval_ms"] > 0 and r["attention_ms"] > 0
        assert r["model_device_ms"] is None  # no device figure from a CPU run

    out = tmp_path / "layout.json"
    res = probe_layout_copies.main(["--device", "cpu", "--reps", "1", "--out", str(out)])
    sh = res["shapes"]["2x256"]
    assert sh["outputs_equal"] and sh["finite"]
    assert sh["prelaid_leaves"] == 0  # on the CPU no CUDA wrapper lays a weight out
    assert res["n_steps"] == 3 and res["n_ensemble"] == 2
    for variant in ("default", "prelaid"):
        assert sh[variant]["wall_s"] > 0 and sh[variant]["ms_per_eval"] > 0 and sh[variant]["profile"] is None
    assert json.loads(out.read_text())["shapes"]["2x256"]["prelaid_leaves"] == 0


def test_bench_packed_train_on_the_cpu(tmp_path):
    out = tmp_path / "train.json"
    defaults = dict(PACKED_DEFAULTS)
    res = bench_packed_train.main(["--device", "cpu", "--out", str(out)])
    assert PACKED_DEFAULTS == defaults  # the packed leg's segment cap is undone
    assert res["metric"] == "sr_train_events_per_sec" and res["n_events"] == 8
    assert res["events_trained_once"] and res["losses_finite"]
    assert len(res["losses"]["bucketed"]) == res["bucketed"]["n_batches"]
    assert len(res["losses"]["packed"]) == res["packed"]["n_batches"] and res["packed"]["S"] == 1024
    assert json.loads(out.read_text())["bucketed"] == res["bucketed"]


def test_every_tool_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)  # a host with a card too
    mains = [profile_inference.main, probe_dispatch.main, bench_kernel.main, bench_packed_kernel.main,
             bench_packed_train.main, measure_serving_latency.main, probe_layout_copies.main]
    for main in mains:
        with pytest.raises(RuntimeError, match="CUDA device"):
            main(["--device", "cuda", "--out", str(tmp_path / "never.json")])
    assert not os.listdir(tmp_path)
    # the outputs' default home is runs/ (git-ignored), never docs/
    assert common.RUNS_DIR == os.path.join(ROOT, "runs", "measure")
