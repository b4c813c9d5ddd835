"""What the measuring scripts share: the card's name and power limit, and
device timing over a CUDA graph of chained launches."""

from __future__ import annotations

import statistics
import subprocess

import torch


def require_cuda(device: str = "cuda") -> torch.device:
    """The card the script measures; without one it raises (a measuring
    script never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"this script measures a CUDA device; device={device!r}, "
                           f"torch.cuda.is_available()={torch.cuda.is_available()}")
    return dev


def card() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


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
