"""Online SR serving: a persistent ensemble sampler behind an HTTP endpoint.

Counterpart of the JAX package's ``inference/server.py``.  A long-lived
process that:

  * loads a checkpoint once, builds the CUDA kernels and runs every bucket
    once at startup (warmup), so requests never pay set-up time;
  * accepts one event per request (LR cells + HR geometry + reorder map,
    the same schema as the file-based pipeline, minus any truth energies);
  * pads the event to the nearest bucket and returns predicted HR ECAL
    energies (MeV) with the per-request device latency.

No external dependencies: stdlib http.server; requests serialize through a
device lock (one card, one stream).  Throughput scaling is horizontal — run
one server per card and shard upstream.

Cross-request batching: concurrent requests that land in the same bucket
within a short window are collated into ONE ensemble-sampler call.  A single
device worker drains a queue; a request entering alone runs immediately at
B=1 (the window is only waited out when other requests are actually in
flight), while N concurrent clients share one call at the exact group row
count.  Buckets above ``batch_max_bucket`` run plain FIFO at B=1.

``device`` is explicit and defaults to ``cuda``; the per-request noise comes
from a device ``torch.Generator`` seeded with the request counter, or from
``noise_fn`` (tests inject the JAX package's draws through it).
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

import numpy as np
import torch

from ..data.sr_dataset import MODEL_BATCH_KEYS, SupResEvents, collate
from ..ops import kernels
from .sr import SRInference, batch_to_device

LOW_KEYS = ("cell_eta", "cell_phi", "cell_layer", "cell_e", "cell_x", "cell_y", "cell_z")

# default buckets cover the full multipart range (events run to ~5k HR
# cells); single_e-only deployments can pass a smaller set to cut warmup time
DEFAULT_BUCKETS = (256, 512, 1024, 2048, 3072, 4096, 5120)


class EventTooLargeError(ValueError):
    """Request event exceeds the largest serving bucket (HTTP 413)."""

    def __init__(self, n: int, max_cells: int):
        super().__init__(
            f"event with {n} HR cells exceeds the largest serving bucket "
            f"{max_cells}; start the server with a larger --buckets set"
        )
        self.n = n
        self.max_cells = max_cells


def _event_to_trees(event: dict):
    """Build in-memory Low/High tree dicts for ``SupResEvents.from_trees``
    (the two-tree file schema without a file; truth energies zero-filled —
    unknown at serving time)."""
    low = {k: [np.asarray(event["low"][k])] for k in LOW_KEYS}
    low["high_cell_to_low_cell_edge"] = [
        np.asarray(event["low"]["high_cell_to_low_cell_edge"], np.int64)
    ]
    n_high = len(event["high"]["cell_eta"])
    high = {}
    for k in LOW_KEYS:
        vals = event["high"].get(k)
        if vals is None and k == "cell_e":
            vals = np.zeros(n_high, np.float32)
        high[k] = [np.asarray(vals)]
    return low, high


class _WorkItem:
    """One queued request: preprocessed event + a completion signal."""

    __slots__ = ("ev", "n", "bucket", "done", "result", "error")

    def __init__(self, ev, n: int, bucket: int):
        self.ev = ev
        self.n = n
        self.bucket = bucket
        self.done = threading.Event()
        self.result = None
        self.error = None


class SRServer:
    def __init__(self, inf_cfg: dict, buckets=DEFAULT_BUCKETS, params=None,
                 max_batch: int | None = None, batch_window_ms: float | None = None,
                 device="cuda", noise_fn: Optional[Callable] = None):
        self.inf = SRInference(inf_cfg, params=params, device=device)
        self.device = self.inf.device
        # noise_fn(request_counter, (E, B, N, 1)) -> array: injected x0
        self.noise_fn = noise_fn
        self.n_ensemble = int(inf_cfg.get("n_ensemble", 10))
        self.method = inf_cfg.get("ode_method", "ab2e")
        self.buckets = sorted(buckets)
        self._lock = threading.Lock()
        self._key_counter = 0
        # cross-request batching: requests in the same bucket arriving within
        # the window share one sampler call at the EXACT group row count (a
        # filler row is pure wasted work).
        self.max_batch = int(
            inf_cfg.get("max_batch", 4) if max_batch is None else max_batch
        )
        self.batch_window_ms = float(
            inf_cfg.get("batch_window_ms", 10.0)
            if batch_window_ms is None
            else batch_window_ms
        )
        # adaptive policy: batch only buckets where a single request
        # underfills the card.  Above batch_max_bucket a lone request carries
        # ens x L^2 work of its own, and grouping adds window waits and
        # lockstep completion.
        self.batch_max_bucket = int(inf_cfg.get("batch_max_bucket", 1024))
        self._cond = threading.Condition()
        self._queue: list[_WorkItem] = []
        self._preprocessing = 0  # requests past entry, not yet enqueued
        self._worker = threading.Thread(target=self._worker_loop, daemon=True)
        self._worker.start()

    # ------------------------------------------------------------------
    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise EventTooLargeError(n, self.buckets[-1])

    def _row_size(self, n_rows: int) -> int:
        return min(n_rows, self.max_batch)

    def predict_event(self, event: dict) -> dict:
        """Synchronous request path: preprocess in the caller's thread
        (overlaps across concurrent clients), enqueue, wait for the device
        worker to run it — alone or batched with concurrent requests."""
        with self._cond:
            self._preprocessing += 1
        try:
            low, high = _event_to_trees(event)
            ds = SupResEvents.from_trees(
                low, high, self.inf.config_mv, make_low=False, make_particles=False
            )
            ev = ds.get_event(0)
            n = len(ev.high["e_proxy"])
            item = _WorkItem(ev, n, self._bucket(n))
        finally:
            with self._cond:
                self._preprocessing -= 1
        with self._cond:
            self._queue.append(item)
            self._cond.notify_all()
        while not item.done.wait(timeout=1.0):
            if not self._worker.is_alive():
                raise RuntimeError("the device worker thread of this SRServer has died")
        if item.error is not None:
            raise item.error
        return item.result

    # ------------------------------------------------------------------
    def _worker_loop(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)  # the device is per thread
        while True:
            with self._cond:
                while not self._queue:
                    self._cond.wait()
                bucket = self._queue[0].bucket
                if bucket > self.batch_max_bucket:
                    # saturated regime: plain FIFO at B=1, no window
                    group = [self._queue.pop(0)]
                else:
                    deadline = time.time() + self.batch_window_ms / 1e3
                    while True:
                        group = [it for it in self._queue if it.bucket == bucket]
                        group = group[: self.max_batch]
                        if len(group) >= self.max_batch:
                            break
                        # wait out the window ONLY while other requests are
                        # still preprocessing (they will enqueue within
                        # ~window) — a lone request runs immediately at B=1
                        if self._preprocessing <= 0 and len(group) == len(self._queue):
                            break
                        remaining = deadline - time.time()
                        if remaining <= 0:
                            break
                        self._cond.wait(timeout=min(remaining, 0.002))
                    group = [
                        it for it in self._queue if it.bucket == bucket
                    ][: self.max_batch]
                    for it in group:
                        self._queue.remove(it)
            try:
                self._run_group(group)
            except Exception as e:  # surface to every waiting caller
                for it in group:
                    it.error = e
                    it.done.set()

    def _noise(self, batch):
        """Injected x0 for this request counter, or None (draw on device)."""
        if self.noise_fn is None:
            return None
        shape = (self.n_ensemble, *batch["e_proxy"].shape)
        x0 = np.asarray(self.noise_fn(self._key_counter, shape), np.float32)
        return torch.from_numpy(x0).to(self.device)

    def _run_group(self, group: list[_WorkItem]):
        pad = group[0].bucket
        b_exec = self._row_size(len(group))
        # filler rows (duplicates of the first event) bring the row count up
        # to the executed size; their outputs are discarded
        evs = [it.ev for it in group] + [group[0].ev] * (b_exec - len(group))
        hb = collate(evs, pad)
        batch = batch_to_device(hb, self.device, MODEL_BATCH_KEYS)
        # every kernel launch (and its launch count) happens under the lock
        with self._lock:
            self._key_counter += 1
            generator = torch.Generator(device=self.device).manual_seed(self._key_counter)
            if self.inf.fast_softmax and not self.inf._nomax_validated:
                # the no-max gate runs on the first REAL request
                self.inf.fast_softmax = self.inf._validate_nomax(batch)
                self.inf._nomax_validated = True
            t0 = time.time()
            out = self.inf._gen(
                batch, generator, n_ensemble=self.n_ensemble, n_steps=self.inf.n_steps,
                method=self.method, fast=self.inf.fast_softmax, x0=self._noise(batch),
            )
            out = out[:, -1].float().cpu().numpy()  # (E, B, N, 1) final state; synchronises
            device_ms = (time.time() - t0) * 1e3
        for i, it in enumerate(group):
            ev, n = it.ev, it.n
            proxy_raw = np.asarray(ev.high["e_proxy_raw"])
            avg = out[:, i, :n, 0]
            e_pred = np.asarray(
                self.inf.target_transform.inverse(avg, proxy_raw[None, :])
            ).mean(0) * 1e3  # unscale-then-avg, GeV -> MeV
            it.result = {
                "n_cells": int(n),
                "bucket": int(pad),
                "e_pred_raw": e_pred.astype(float).tolist(),
                "eta": np.asarray(ev.high["eta_raw"]).astype(float).tolist(),
                "phi": np.asarray(ev.high["phi"]).astype(float).tolist(),
                "layer": np.asarray(ev.high["layer"]).astype(int).tolist(),
                "device_ms": round(device_ms, 2),
                "batched_with": len(group),
            }
            it.done.set()

    def warmup(self, batch_sizes=(1,), buckets=None):
        """Build the CUDA kernels and run every bucket once with a dummy
        event.  Nothing is compiled per shape, so one row count per bucket
        (``batch_sizes``, default a single row) is enough to touch every
        code path and fill the allocator's pools."""
        if self.device.type == "cuda":
            kernels.library()
        for b in (self.buckets if buckets is None else sorted(buckets)):
            b_sizes = batch_sizes if b <= self.batch_max_bucket else [r for r in batch_sizes if r == 1]
            for rows in b_sizes:
                full = {
                    "eta": np.zeros((rows, b, 1), np.float32), "cosphi": np.ones((rows, b, 1), np.float32),
                    "sinphi": np.zeros((rows, b, 1), np.float32),
                    "layer": np.zeros((rows, b, 1), np.int32),
                    "e_proxy": np.zeros((rows, b, 1), np.float32), "q_mask": np.ones((rows, b), bool),
                    "target": np.zeros((rows, b, 1), np.float32),
                }
                batch = batch_to_device(full, self.device, MODEL_BATCH_KEYS)
                # NOTE: the no-max saturation gate must run on REAL shower
                # data (an all-zeros dummy has trivially in-bound logits and
                # would rubber-stamp the fast kernel), so _nomax_validated is
                # left unset for the first real request
                t0 = time.time()
                with self._lock:
                    out = self.inf._gen(
                        batch, torch.Generator(device=self.device).manual_seed(0),
                        n_ensemble=self.n_ensemble, n_steps=self.inf.n_steps, method=self.method,
                        fast=self.inf.fast_softmax,
                    )
                    float(out.float().sum().cpu())
                print(
                    f"[serve] warmed bucket {b} x {rows} rows: {time.time() - t0:.1f}s",
                    flush=True,
                )

    # ------------------------------------------------------------------
    def serve(self, host="127.0.0.1", port=8310):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path == "/health":
                    body = json.dumps({"ok": True, "buckets": server.buckets}).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    self.send_response(404)
                    self.end_headers()

            def do_POST(self):
                if self.path != "/predict":
                    self.send_response(404)
                    self.end_headers()
                    return
                try:
                    length = int(self.headers["Content-Length"])
                    event = json.loads(self.rfile.read(length))
                    t0 = time.time()
                    result = server.predict_event(event)
                    result["total_ms"] = round((time.time() - t0) * 1e3, 2)
                    body = json.dumps(result).encode()
                    code = 200
                except EventTooLargeError as e:  # graceful oversize handling
                    body = json.dumps(
                        {"error": str(e), "n_cells": e.n, "max_cells": e.max_cells}
                    ).encode()
                    code = 413
                except Exception as e:  # surface errors to the client
                    body = json.dumps({"error": f"{type(e).__name__}: {e}"}).encode()
                    code = 400
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        httpd = ThreadingHTTPServer((host, port), Handler)
        print(f"[serve] listening on {host}:{port}", flush=True)
        httpd.serve_forever()
