"""Measure one checkout's bf16 flash-attention forward (K1, K2, K7) on the card:
the kernels' device time at ``chip_smoke.py``'s shapes (with their error
against the plain versions), the host cost of one eager launch, one serve
sampler call under ``torch.profiler`` (wall and device time), and the serve
phase's per-request ``device_ms`` three times over.  ``compare_fwd.sh`` runs
it for two checkouts in the order old, new, new, old.

    python3 superresolutionhep_tpu_torch/tools/compare_fwd.py <checkout> <label>

The checkout is imported (its ``chip_smoke.py`` and package) and builds its
kernels into ``<checkout>/build``.  Prints one JSON line per measurement,
tagged with the label.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import sys
import time


def main():
    root, label = os.path.abspath(sys.argv[1]), sys.argv[2]
    sys.path.insert(0, root)
    os.environ["SRHEP_TORCH_BUILD_DIR"] = os.path.join(root, "build")
    import torch

    import chip_smoke as cs
    from superresolutionhep_tpu_torch.ops import flash_attention as fa
    from superresolutionhep_tpu_torch.ops import flash_packed as fp
    from superresolutionhep_tpu_torch.ops import kernels
    from superresolutionhep_tpu_torch.scripts.common import graph_ms

    if not torch.cuda.is_available():
        raise SystemExit("compare_fwd: no CUDA device")
    kernels.library()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)

    def emit(kind, obj):
        print(json.dumps({"label": label, "kind": kind, **obj}), flush=True)

    # ---- device time of the kernels alone (pre-scaled q), chip_smoke's shapes
    B, H, D, F = 10, 4, 64, 256
    times = {}
    for L in (512, 2048):
        valid, _ = cs.ragged_valid(B, L, dev)
        qkv = torch.randn(B, L, 3 * F, generator=g, device=dev)
        qkv[..., :F] *= 0.5
        qkv = qkv.to(torch.bfloat16)
        q, k, v = (qkv[..., i * F:(i + 1) * F].view(B, L, H, D) for i in range(3))
        m = valid.float().contiguous()
        for name, nomax in (("k1", False), ("k2", True)):
            out, _ = fa._flash_fwd_cuda(q, k, v, m, m, nomax=nomax, with_lse=not nomax)
            ref = fa._ref_attention_base2(*(t.permute(0, 2, 1, 3) for t in (q, k, v)), m[:, None], m[:, None],
                                          "nomax_clip" if nomax else "max")
            times[f"{name}_L{L}"] = {
                "ms": graph_ms(lambda: fa._flash_fwd_cuda(q, k, v, m, m, nomax=nomax, with_lse=not nomax), 20, chain=8),
                "max_abs_err": (out.float() - ref.permute(0, 2, 1, 3).float()).abs().max().item()}
    _, seg_np, _ = cs.packed_layout()
    seg = torch.from_numpy(seg_np).to(dev)
    qkv = torch.randn(seg.shape[0], seg.shape[1], 3, H, D, generator=g, device=dev)
    qkv[:, :, 0] *= (1.0 / D ** 0.5) * fp.LOG2E * 2.0
    qkv = qkv.to(torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    for name, nomax in (("k7", False), ("k7_nomax", True)):
        out, _ = fp._packed_fwd(q, k, v, seg, nomax=nomax, with_lse=not nomax)
        ref = fp._ref_packed_fwd(*(t.permute(0, 2, 1, 3) for t in (q, k, v)), seg, "nomax_clip" if nomax else "max")
        ref = ref.permute(0, 2, 1, 3).float()
        times[name] = {  # the wrapper's whole device work: the band table (if any) and the kernel
            "ms": graph_ms(lambda: fp._packed_fwd(q, k, v, seg, nomax=nomax, with_lse=not nomax), 20, chain=8),
            "max_rel_err": ((out.float() - ref).abs().max() / ref.abs().max()).item()}
    emit("kernel_ms", times)

    # ---- host cost of one eager launch at a small shape (best of 5 x 500)
    qs = torch.randn(10, 512, 4, 64, device=dev).to(torch.bfloat16)
    ms = torch.ones(10, 512, device=dev)
    segs = torch.zeros(8, 512, dtype=torch.int32, device=dev)
    host = {}
    for name, fn in (("k2", lambda: fa._flash_fwd_cuda(qs, qs, qs, ms, ms, nomax=True, with_lse=False)),
                     ("k7_nomax", lambda: fp._packed_fwd(qs[:8], qs[:8], qs[:8], segs, nomax=True, with_lse=False))):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        best = float("inf")
        for _ in range(5):
            t0 = time.perf_counter()
            for _ in range(500):
                fn()
            best = min(best, (time.perf_counter() - t0) / 500 * 1e6)
            torch.cuda.synchronize()
        host[name] = best
    emit("host_us_per_call", host)

    # ---- one serve sampler call (10 members, 24 evaluations, no-max) under
    # torch.profiler, for the smallest and the largest of 8 synthetic events
    from superresolutionhep_tpu_torch.configs import MULTIPART_CONFIG_MV, serve_inference_config
    from superresolutionhep_tpu_torch.data.sr_dataset import MODEL_BATCH_KEYS, collate
    from superresolutionhep_tpu_torch.inference.sr import SRInference, batch_to_device
    from superresolutionhep_tpu_torch.tools.convert import init_params_jax_layout, params_from_jax

    flow_cfg = MULTIPART_CONFIG_MV["flow_model"]
    params = params_from_jax(init_params_jax_layout(flow_cfg, seed=0), flow_cfg)
    inf = SRInference(serve_inference_config(), params=params, device="cuda")
    ds = cs.multipart_dataset(MULTIPART_CONFIG_MV, 8, 21, make_low=True, make_particles=True, max_particles=4,
                              window_lr_cells=2)
    counts = list(ds.cell_count_high)
    for i in (counts.index(min(counts)), counts.index(max(counts))):
        pad = next(b for b in (512, 1024, 2048, 4096, 8192) if b >= counts[i])
        batch = batch_to_device(collate([ds.get_event(i)], pad), dev, MODEL_BATCH_KEYS)
        gen = torch.Generator(device=dev).manual_seed(0)

        def step():
            return inf._gen(batch, gen, n_ensemble=10, n_steps=inf.n_steps, method="ab2e", fast=True)

        step()
        torch.cuda.synchronize()
        prof = cs.profile_steps(step, 3)
        emit("serve_sampler_profile", {"cells": counts[i], "bucket": pad, **{k: prof[k] for k in (
            "wall_ms_per_step", "device_ms_per_step", "busy_share", "kernels_per_step")}, "top": prof["top"][:4]})

    # ---- the serve phase, three times (its own line is swallowed)
    for rep in range(3):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cs.serve_phase()
        line = next(json.loads(x) for x in buf.getvalue().splitlines() if x.startswith('{"phase": "serve"'))
        emit("serve_device_ms", {"rep": rep, "requests": {r["label"]: r["device_ms"] for r in line["requests"]}})


if __name__ == "__main__":
    main()
