"""What the measuring scripts share: the card's name and power limit, the
device a tool runs on, device timing over a CUDA graph of chained launches,
the attention kernels' bounds on an H100, and where the outputs go."""

from __future__ import annotations

import copy
import json
import os
import statistics
import subprocess
import time

import torch

from ..configs import MULTIPART_CONFIG_MV
from . import REPO_ROOT

# published peaks of one H100 SXM (dense, no sparsity), at the full 700 W
H100_BYTES_PER_S = 3.35e12
H100_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense tensor-core bf16; fp32 outside them
H100_TF32_FLOPS = 495e12  # dense TF32 on the tensor cores
# the fp32 attention kernels take each product as three TF32 ones (lo*hi + hi*lo + hi*hi)
TF32_SPLIT_TERMS = 3

# the tools' default output directory (git-ignored); nothing here writes under docs/
RUNS_DIR = os.path.join(REPO_ROOT, "runs", "measure")


def require_cuda(device: str = "cuda") -> torch.device:
    """The card the script measures; without one it raises (a measuring
    script never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"this script measures a CUDA device; device={device!r}, "
                           f"torch.cuda.is_available()={torch.cuda.is_available()}")
    return dev


def measure_device(device: str = "cuda") -> torch.device:
    """The device a measuring tool runs on: a card (``require_cuda``, which
    raises without one), or the CPU when asked for by name — the tests' tiny
    runs, whose times are no device figure."""
    dev = torch.device(device)
    return dev if dev.type == "cpu" else require_cuda(device)


def tiny_config_mv() -> dict:
    """The tools' ``--device cpu`` model: the multipart configuration at
    h 32 with 2 DiT layers (the tests' size; the card runs the full width)."""
    mv = copy.deepcopy(MULTIPART_CONFIG_MV)
    fm = mv["flow_model"]
    fm["h_dim"] = fm["feat_0_mlp"]["output_size"] = 32
    fm["transformer"]["num_transformer_layers"] = 2
    fm["transformer"]["dense_config"]["hidden_layers"] = [32]
    return mv


def card() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def device_line(dev: torch.device) -> str:
    """The line a tool prints before its numbers: ``card()`` on the card."""
    return card() if dev.type == "cuda" else "cpu (no card: times from this run are no device figure)"


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def graph_ms(fn, reps: int = 20, chain: int = 8) -> float:
    """Device time of one call of ``fn`` in ms: ``chain`` calls captured into
    one CUDA graph (the dispatch-free chain), the graph replayed ``reps``
    times between CUDA events, the median divided by ``chain``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up outside the capture
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(chain):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / chain)
    del graph
    return statistics.median(times)


def chained_ms(fn, dev: torch.device, reps: int) -> float:
    """``graph_ms(fn, reps, chain=1)`` on the card (``fn`` launches the whole
    chain; 2 warm-up calls and 1 captured call run it eagerly); on the CPU the
    median wall time of ``reps`` calls after one warm-up."""
    if dev.type == "cuda":
        return graph_ms(fn, reps=reps, chain=1)
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def write_json(path: str, obj) -> str:
    """``obj`` as JSON at ``path`` (directories made); returns the path."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fp:
        json.dump(obj, fp, indent=1)
    return path


def max_sm_clock_hz():
    """The card's maximum SM clock, for the special-function unit's bound."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    return float(out) * 1e6


def sfu_per_s():
    """fp32 exponentials a second on the card: 16 a clock per SM (the
    special-function units) at the maximum SM clock."""
    return 16 * torch.cuda.get_device_properties(0).multi_processor_count * max_sm_clock_hz()


def fwd_bounds(flops, nbytes, exps, peak):
    """The forward kernels' bound: the larger of the operations over the
    tensor-core peak, the bytes over the memory rate, and one fp32 exp2 per
    needed (query, key) pair over the special-function units' rate."""
    t = {"operations": flops / peak, "bytes": nbytes / H100_BYTES_PER_S}
    sfu = exps / sfu_per_s()
    return {"bound_ms": max(t["operations"], t["bytes"], sfu) * 1e3,
            "bound_by": "operations" if max(t["operations"], sfu) >= t["bytes"] else "bytes",
            "operations_ms": t["operations"] * 1e3, "bytes_ms": t["bytes"] * 1e3, "sfu_bound_ms": sfu * 1e3}


def fp32_attention_bounds(flops, nbytes, exps):
    """The fp32 attention kernels' bound (K1/K2/K7 and K5/K6/K8/K9 on fp32
    operands): the largest of the products as three-term TF32 splits on the
    tensor cores (3 * flops / 495 TFLOP/s), the bytes over the memory rate,
    and one fp32 exp2 per needed (query, key) pair on the special-function
    units (the backward recomputes one a pair).  ``bound_term`` names the
    term that sets it; ``fma_bound_ms`` is the CUDA-core yardstick of earlier
    rows (the flops at 67 TFLOP/s, or the bytes)."""
    t = {"tf32x3": TF32_SPLIT_TERMS * flops / H100_TF32_FLOPS, "bytes": nbytes / H100_BYTES_PER_S,
         "sfu": exps / sfu_per_s()}
    term = max(t, key=t.get)
    return {"bound_ms": t[term] * 1e3, "bound_by": "bytes" if term == "bytes" else "operations",
            "bound_term": term, "operations_ms": t["tf32x3"] * 1e3, "bytes_ms": t["bytes"] * 1e3,
            "sfu_bound_ms": t["sfu"] * 1e3,
            "fma_bound_ms": max(flops / H100_FLOPS[torch.float32], t["bytes"]) * 1e3}


def attention_bounds(dtype, flops, nbytes, exps):
    """``fwd_bounds`` at the bf16 peak for bf16 operands,
    ``fp32_attention_bounds`` for fp32 ones."""
    if dtype == torch.float32:
        return fp32_attention_bounds(flops, nbytes, exps)
    return fwd_bounds(flops, nbytes, exps, H100_FLOPS[torch.bfloat16])
