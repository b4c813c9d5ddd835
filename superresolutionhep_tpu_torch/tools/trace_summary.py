"""Summarise a ``torch.profiler`` trace of the card: device time by class.

Counterpart of the JAX package's ``tools/trace_summary.py``, which reads the
xplane protos of ``jax.profiler``.  This one reads the Chrome trace that
``torch.profiler`` exports (``prof.export_chrome_trace``, the ``trace.json``
of ``train/metrics.py``, the ``--trace`` directories of the measuring tools),
or a live ``profile`` object (``events_from_profile``), and aggregates the
device events (kernels, memcpy, memset) into classes:

  * ``hand-kernel``  — the port's hand-written CUDA kernels, named from their
    ``__global__`` entry points in ``csrc/`` (``HAND_KERNELS``), each mapped
    to the launch counter of ``ops/kernels.py::LAUNCHES`` that its wrapper
    adds to (the JAX tool's ``pallas-attention``);
  * ``gemm``        — cuBLAS / CUTLASS products;
  * ``elementwise/reduce`` — ``at::native`` elementwise and reduction kernels;
  * ``copy/layout`` — Memcpy, Memset, copies and casts, transposes, ``cat``;
  * ``collective``  — NCCL;
  * ``other``.

For each trace (each file under a directory, as the JAX tool takes each
xplane file), per GPU stream it reports the covered span (first start to
last end), the summed event time, the busy time (the union of the events'
intervals) and the busy share of the span; then the time and share per
class and the top ops, over all streams.

    python -m superresolutionhep_tpu_torch.tools.trace_summary <trace.json | dir> [--top 15]
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import glob
import gzip
import json
import os
import re
import time
from typing import Dict, Iterable, List, Optional

import torch

from ..ops import kernels

# Chrome-trace categories of device activity
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# ProfiledWindow's pads: torch.cuda._sleep's kernel, left out of every summary
PAD_KERNEL = "spin_kernel"
# pad kernels run before the block and after it: on the H100 (torch 2.11) the
# profiler lost the first device records of a window, 0 in a fresh process
# and 3, 5, ~18 and 22 in processes with minutes of work behind them
PAD_BEFORE, PAD_AFTER = 512, 64
CLASSES = ("hand-kernel", "gemm", "elementwise/reduce", "copy/layout", "collective", "other")


def _true(arg: str) -> bool:  # a bool template argument as a demangler prints it
    return arg in ("true", "1", "(bool)1")


def _fwd_key(targs):  # <D, NOMAX, SEG, ...>
    nomax, seg = _true(targs[1]), _true(targs[2])
    return ("packed_fwd" if seg else "flash_fwd") + ("_nomax" if nomax else "")


def _bwd_key(kind):  # <D, SEG, ...>
    return lambda targs: ("packed_" if _true(targs[1]) else "flash_") + kind


# every __global__ entry point of csrc/*.cu -> the LAUNCHES key its wrapper
# counts, from the demangled template arguments the profiler shows
HAND_KERNELS = {
    "flash_fwd_wgmma_kernel": _fwd_key,
    "flash_fwd_f32_kernel": _fwd_key,
    "packed_band_kernel": lambda targs: "packed_band",
    "flash_bwd_dq_wgmma_kernel": _bwd_key("bwd_dq"),
    "flash_bwd_dq_f32_kernel": _bwd_key("bwd_dq"),
    "flash_bwd_dkv_wgmma_kernel": _bwd_key("bwd_dkv"),
    "flash_bwd_dkv_f32_kernel": _bwd_key("bwd_dkv"),
    "fused_qkv_wgmma_kernel": lambda targs: "fused_qkv",
    "fused_qkv_f32_kernel": lambda targs: "fused_qkv",
    "fused_mlp_wgmma_kernel": lambda targs: "fused_mlp",
    "fused_mlp_f32_kernel": lambda targs: "fused_mlp",
    # <MODE, MASK, NC, BK>: the masked instantiations are K11's
    "probe_fwd_wgmma_kernel": lambda targs: "probe_exp_dtype" if _true(targs[1]) else "probe_variant",
}
_ENTRY = re.compile(r"\b(\w+_kernel)\b(?:<([^()]*)>)?")


@dataclasses.dataclass(frozen=True)
class DeviceEvent:
    name: str
    device: int
    stream: int
    ts: float  # start, us
    dur: float  # us


def _entry(name: str, table):
    return next((m for m in _ENTRY.finditer(name) if m.group(1) in table), None)


def entry_name(name: str, table=HAND_KERNELS) -> Optional[str]:
    """The ``__global__`` entry point of ``table`` an event name calls, or None."""
    m = _entry(name, table)
    return None if m is None else m.group(1)


def hand_kernel(name: str, table=HAND_KERNELS) -> Optional[str]:
    """The ``LAUNCHES`` key of a hand-written kernel's event name, or None."""
    m = _entry(name, table)
    return None if m is None else table[m.group(1)]([a.strip() for a in (m.group(2) or "").split(",")])


def classify(name: str, table=HAND_KERNELS) -> str:
    if hand_kernel(name, table) is not None:
        return "hand-kernel"
    n = name.lower()
    if "nccl" in n:
        return "collective"
    if any(s in n for s in ("memcpy", "memset", "copy", "transpose", "catarray", "cat_")):
        return "copy/layout"
    if any(s in n for s in ("gemm", "cutlass", "cublas", "nvjet", "xmma", "gemv")):
        return "gemm"
    if any(s in n for s in ("at::native", "elementwise", "reduce")):
        return "elementwise/reduce"
    return "other"


def trace_files(path: str) -> List[str]:
    """``path``, or every Chrome trace (``.json``, ``.json.gz``) under it."""
    if not os.path.isdir(path):
        return [path]
    paths = sorted(p for ext in ("*.json", "*.json.gz") for p in glob.glob(os.path.join(path, "**", ext), recursive=True))
    if not paths:
        raise SystemExit(f"no Chrome trace (*.json, *.json.gz) under {path}")
    return paths


def load_trace(path: str) -> List[DeviceEvent]:
    """The device events of a Chrome trace file (``.json`` or ``.json.gz``)."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fp:
        trace = json.load(fp)
    out = []
    for e in trace.get("traceEvents", trace if isinstance(trace, list) else []):
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS and PAD_KERNEL not in e["name"]:
            args = e.get("args", {})
            out.append(DeviceEvent(e["name"], int(args.get("device", e.get("pid", 0))),
                                   int(args.get("stream", e.get("tid", 0))), float(e["ts"]), float(e["dur"])))
    return out


def events_from_profile(prof) -> List[DeviceEvent]:
    """The device events of a live ``torch.profiler.profile`` (after exit);
    ``record_function`` ranges, which the profiler also puts on the device's
    line, are left out (the Chrome trace's ``gpu_user_annotation``)."""
    out = []
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA and not getattr(e, "is_user_annotation", False)
                and PAD_KERNEL not in e.name):
            out.append(DeviceEvent(e.name, int(e.device_index), int(getattr(e, "device_resource_id", 0) or 0),
                                   float(e.time_range.start), float(e.time_range.elapsed_us())))
    return out


def _union_us(intervals) -> float:
    busy, end = 0.0, None
    for lo, hi in sorted(intervals):
        if end is None or lo > end:
            busy += hi - lo
            end = hi
        elif hi > end:
            busy += hi - end
            end = hi
    return busy


def _span(events) -> float:
    return max(e.ts + e.dur for e in events) - min(e.ts for e in events) if events else 0.0


def hand_kernel_counts(events: Iterable[DeviceEvent], table=HAND_KERNELS) -> Dict[str, int]:
    """Events of each hand-written kernel, by its ``LAUNCHES`` key."""
    return dict(collections.Counter(k for k in (hand_kernel(e.name, table) for e in events) if k is not None))


def summarize(events: List[DeviceEvent], top: int = 15, table=HAND_KERNELS) -> dict:
    """Per stream: span, summed time, busy (union) time and busy share; over
    all streams the same, the time and share per class (shares of the summed
    time), the ``top`` ops by summed time and the hand-kernel event counts.
    Times in us."""
    per_stream = collections.defaultdict(list)
    per_op, per_class, op_count = {}, {c: 0.0 for c in CLASSES}, collections.Counter()
    for e in events:
        per_stream[(e.device, e.stream)].append(e)
        per_op[e.name] = per_op.get(e.name, 0.0) + e.dur
        op_count[e.name] += 1
        per_class[classify(e.name, table)] += e.dur
    kernel_us = sum(per_op.values())
    streams = []
    for (d, s), evs in sorted(per_stream.items()):
        span, busy = _span(evs), _union_us((e.ts, e.ts + e.dur) for e in evs)
        streams.append({"device": d, "stream": s, "events": len(evs), "span_us": span,
                        "kernel_us": sum(e.dur for e in evs), "busy_us": busy,
                        "busy_share": busy / span if span > 0 else 0.0})
    span = _span(events)
    busy = _union_us((e.ts, e.ts + e.dur) for e in events)
    return {
        "events": len(events), "span_us": span, "kernel_us": kernel_us, "busy_us": busy,
        "busy_share": busy / span if span > 0 else 0.0, "streams": streams,
        "classes": {c: {"us": us, "share": us / kernel_us if kernel_us > 0 else 0.0} for c, us in per_class.items()},
        "top": [{"name": n, "us": us, "count": op_count[n]}
                for n, us in sorted(per_op.items(), key=lambda kv: -kv[1])[:top]],
        "hand_kernels": hand_kernel_counts(events, table),
    }


def brief(summary: dict) -> dict:
    """The figures a tool's JSON line carries: device ms, busy share, the
    per-class ms and shares and the hand-kernel event counts."""
    return {"device_ms": summary["kernel_us"] / 1e3, "busy_ms": summary["busy_us"] / 1e3,
            "span_ms": summary["span_us"] / 1e3, "busy_share": summary["busy_share"],
            "events": summary["events"],
            "classes": {c: {"ms": v["us"] / 1e3, "share": v["share"]} for c, v in summary["classes"].items()
                        if v["us"] > 0},
            "hand_kernels": summary["hand_kernels"]}


class ProfiledWindow:
    """``torch.profiler`` over a block of work (on the card its CUDA
    activity, and with ``host_ops`` the host's operators too, which costs the
    profiler several seconds a window of ~15k kernels after the block), with
    the hand-kernel launch counters read over the same block.
    After the block: ``wall_ms`` (host clock, the device synchronised inside
    the window), ``events``, ``summary`` (``summarize``) and ``launches``
    (the ``LAUNCHES`` delta, kernels launched at least once); with
    ``trace_path`` the window's Chrome trace is written there, at the
    window's end (a trace exported after the events were read came back with
    zero durations, torch 2.11).  On the card ``PAD_BEFORE`` tiny spin
    kernels run (synchronised) before the block and ``PAD_AFTER`` after it,
    so that the records the profiler loses at a window's start are pads;
    ``complete`` says that a pad was recorded before the block's first device
    event and one after its last, so none of the block's was lost.  The pads
    are left out of every summary."""

    def __init__(self, dev: torch.device, label: str = "", trace_path: Optional[str] = None,
                 host_ops: bool = False):
        self.dev, self.label, self.trace_path, self.host_ops = dev, label, trace_path, host_ops

    def _pad(self, n):
        for _ in range(n):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize(self.dev)

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = ([ProfilerActivity.CPU] if self.host_ops or self.dev.type != "cuda" else []) + (
            [ProfilerActivity.CUDA] if self.dev.type == "cuda" else [])
        self._before = dict(kernels.LAUNCHES)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        if self.dev.type == "cuda":
            self._pad(PAD_BEFORE)
        self._t0 = time.time()
        return self

    def __exit__(self, *exc):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        t1 = time.time()
        self.wall_ms = (t1 - self._t0) * 1e3
        if self.dev.type == "cuda":
            self._pad(PAD_AFTER)
        t2 = time.time()
        self._prof.__exit__(*exc)
        if exc[0] is None:
            if self.trace_path:
                os.makedirs(os.path.dirname(os.path.abspath(self.trace_path)), exist_ok=True)
                self._prof.export_chrome_trace(self.trace_path)
            self.events = events_from_profile(self._prof)
            pads = [e.time_range.start for e in self._prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA and PAD_KERNEL in e.name]
            self.complete = self.dev.type != "cuda" or (
                len(pads) >= 2 and (not self.events or min(pads) <= min(e.ts for e in self.events)
                                    and max(pads) >= max(e.ts for e in self.events)))
            self.summary = summarize(self.events)
            self.launches = {k: v - self._before[k] for k, v in kernels.LAUNCHES.items() if v != self._before[k]}
            self.after_s = time.time() - t2  # the profiler's own cost after the window (and the trace's export)
        return False

    def agrees(self, table=HAND_KERNELS) -> bool:
        """The hand-kernel events classified with ``table`` equal the launch
        counters' delta, kernel by kernel."""
        return hand_kernel_counts(self.events, table) == self.launches

    def record(self) -> dict:
        return {"label": self.label, "wall_ms": self.wall_ms, "after_s": self.after_s, "complete": self.complete,
                **brief(self.summary), "launches": self.launches}


def print_summary(summary: dict, top: int = 15, title: str = "") -> None:
    if title:
        print(f"\n== {title}")
    for s in summary["streams"]:
        print(f"   device {s['device']} stream {s['stream']}: covered span {s['span_us'] / 1e3:.3f} ms, "
              f"summed {s['kernel_us'] / 1e3:.3f} ms, busy {s['busy_us'] / 1e3:.3f} ms "
              f"({100.0 * s['busy_share']:.1f}% of the span), {s['events']} events")
    print(f"   all streams: covered span {summary['span_us'] / 1e3:.3f} ms, summed {summary['kernel_us'] / 1e3:.3f} ms, "
          f"busy {100.0 * summary['busy_share']:.1f}%")
    for cls, v in sorted(summary["classes"].items(), key=lambda kv: -kv[1]["us"]):
        if v["us"] > 0:
            print(f"   {cls:22s} {v['us'] / 1e3:10.3f} ms  {100.0 * v['share']:5.1f}%")
    print(f"   -- top {top} ops --")
    for op in summary["top"][:top]:
        print(f"   {op['us'] / 1e3:10.3f} ms  {op['count']:6d}x  {op['name'][:90]}")
    if summary["hand_kernels"]:
        print("   hand-written kernels (events):", json.dumps(summary["hand_kernels"], sort_keys=True))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trace", help="a Chrome trace (.json, .json.gz) or a directory of them")
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    out = []
    for path in trace_files(args.trace):
        summary = summarize(load_trace(path), top=args.top)
        print_summary(summary, args.top, title=path)
        out.append((path, summary))
    return out


if __name__ == "__main__":
    main()
