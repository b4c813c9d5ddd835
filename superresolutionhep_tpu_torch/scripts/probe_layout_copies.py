"""Probe the copy/layout residual inside the production sampler call.

Counterpart of the JAX package's ``scripts/probe_layout_copies.py``, with its
configuration: the no-max kernel, the fused prologue and MLP (K2, K3, K4),
weights cast to bf16 once (``models/precision.py::cast_params_for_inference``),
``ab2`` at 25 points, 10 members, at (64, 1536) and (10, 5120).  Two variants:

  A. ``default``: the weights as the model holds them;
  B. ``prelaid``: every weight that a kernel wrapper copies into its own
     layout on each call (``ops/fused_qkv.py::_cuda_ln_mod_proj``,
     ``ops/fused_mlp.py::_cuda_dit_mlp``: a transposed weight made
     contiguous, a bias made contiguous fp32) laid out once, before the
     calls, and handed to the wrapper in its place.  XLA's ``Layout.AUTO``,
     which the JAX script's variant B asks for, has no eager counterpart;
     ``prelaid_leaves`` (the count of such weights, found by watching the
     wrappers' arguments over one model evaluation) stands where the JAX
     script's ``auto_nonrowmajor_leaves`` does.  Casts that the model itself
     makes (the LayerNorm scales folded in fp32) are not a wrapper's and are
     not counted.

Per variant: the wall time of a sampler call (``reps`` after a first call and
a warm one) and per model evaluation, the first call's time (``compile_s``:
nothing is compiled here), and the per-class device time of one more call
under ``torch.profiler`` (``tools/trace_summary.py``).  Both variants draw the
same noise, so their samples must be equal (``outputs_equal``).  One model
evaluation per shape runs first under ``checked()`` (``chip_smoke.py`` passes
its launch checker).

    python -m superresolutionhep_tpu_torch.scripts.probe_layout_copies [--trace DIR] [--reps 5] [--device cuda]

Prints the card's name and power limit, a line per variant, then the result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import numpy as np
import torch

from ..configs import MULTIPART_CONFIG_MV
from ..flow.sampling import generate_ensemble
from ..models.precision import cast_params_for_inference
from ..ops import fused_mlp, fused_qkv
from ..tools.flops import sampler_evals
from ..tools.profile_inference import make_batch, random_model
from ..tools.trace_summary import ProfiledWindow, brief
from .common import RUNS_DIR, device_line, measure_device, sync, tiny_config_mv, write_json

SHAPES = [(64, 1536), (10, 5120)]
N_STEPS = 25
N_ENSEMBLE = 10
TINY = {"shapes": [(2, 256)], "n_steps": 3, "n_ensemble": 2}  # the JAX script's PROBE_TINY; --device cpu

# the CUDA wrappers that lay weights out per call: argument positions of
# their weights, and the layout each takes ("t": a (F, O) weight whose
# transpose it makes contiguous; "bias": a contiguous fp32 vector)
WRAPPERS = ((fused_qkv, "_cuda_ln_mod_proj", {3: "t", 4: "bias"}),
            (fused_mlp, "_cuda_dit_mlp", {6: "t", 7: "bias", 8: "t", 9: "bias"}))


def _key(t):
    return (t.data_ptr(), t.dtype, tuple(t.shape), t.stride())


def _laid_out(t, kind):
    """``t`` in the layout the wrapper makes of it, or None if it is already."""
    if kind == "t":
        return None if t.t().is_contiguous() else t.t().contiguous().t()
    if t.dtype == torch.float32 and t.is_contiguous():
        return None
    return t.reshape(-1).float().contiguous().reshape(t.shape)


@contextlib.contextmanager
def _wrapped(replace):
    """Each wrapper of ``WRAPPERS`` replaced by ``replace(fn, roles)``."""
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in WRAPPERS]
    try:
        for (mod, name, roles), (_, _, fn) in zip(WRAPPERS, saved):
            setattr(mod, name, replace(fn, roles))
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def find_prelaid(call):
    """Run ``call()`` watching the wrappers: every weight argument a wrapper
    would copy into its layout, laid out once.  {key: tensor}."""
    table = {}

    def watch(fn, roles):
        def spy(*args, **kw):
            for i, kind in roles.items():
                if _key(args[i]) not in table:
                    laid = _laid_out(args[i], kind)
                    if laid is not None:
                        table[_key(args[i])] = laid
            return fn(*args, **kw)
        return spy

    with _wrapped(watch):
        call()
    return table


@contextlib.contextmanager
def prelaid(table):
    """The wrappers handed the laid-out weights of ``table`` in place of the originals."""
    def swap(fn, roles):
        def sub(*args, **kw):
            args = list(args)
            for i in roles:
                args[i] = table.get(_key(args[i]), args[i])
            return fn(*args, **kw)
        return sub

    with _wrapped(swap):
        yield


@torch.no_grad()
def probe(dev, reps=5, shapes=SHAPES, n_steps=N_STEPS, n_ensemble=N_ENSEMBLE, config_mv=MULTIPART_CONFIG_MV,
          trace=None, checked=contextlib.nullcontext, windows=None):
    rng = np.random.default_rng(0)
    results = {"device": str(dev), "n_steps": n_steps, "n_ensemble": n_ensemble, "method": "ab2", "shapes": {}}
    # ab2 costs exactly n_steps model evaluations (its Heun bootstrap's two
    # cover the first two grid points)
    n_evals = sampler_evals(n_steps, "ab2") * n_ensemble
    for B, L in shapes:
        skey = f"{B}x{L}"
        batch = make_batch(B, L, rng, dev)
        model = random_model(config_mv, dev, attn_impl="flash_nomax", fused_prologue=True, dtype=torch.bfloat16)
        cast_params_for_inference(model)
        t_half = torch.full((B,), 0.5, device=dev)

        def run_batch():
            gen = torch.Generator(device=dev).manual_seed(1)
            return generate_ensemble(model, batch, n_ensemble=n_ensemble, n_steps=n_steps, method="ab2",
                                     ret_seq=False, generator=gen)

        with checked():
            model(batch, batch["e_proxy"], t_half)
        table = find_prelaid(lambda: model(batch, batch["e_proxy"], t_half))
        shape_res = {"prelaid_leaves": len(table)}
        if not table:
            shape_res["prelaid_note"] = "no wrapper copied a weight per call: variant B equals variant A"
        outs = {}
        for variant in ("default", "prelaid"):
            ctx = prelaid(table) if variant == "prelaid" else contextlib.nullcontext()
            with ctx:
                t0 = time.time()
                run_batch()
                sync(dev)
                compile_s = time.time() - t0
                run_batch()  # warm
                sync(dev)
                t0 = time.time()
                for _ in range(reps):
                    out = run_batch()
                sync(dev)
                wall = (time.time() - t0) / reps
                trace_path = os.path.join(trace, f"{skey}_{variant}.json") if trace else None
                with ProfiledWindow(dev, f"probe_layout_copies {skey} {variant} sampler call", trace_path) as w:
                    run_batch()
            if windows is not None:
                windows.append(w)
            outs[variant] = out
            shape_res[variant] = {
                "wall_s": round(wall, 4),
                "ms_per_eval": round(wall / n_evals * 1e3, 3),
                "compile_s": round(compile_s, 1),
                "trace": trace_path,
                "profile": brief(w.summary) if dev.type == "cuda" else None,
            }
            print(f"[{skey}] {variant}: {wall:.4f} s/batch, {wall / n_evals * 1e3:.3f} ms/eval "
                  f"(first call {compile_s:.1f}s), device copy/layout "
                  f"{w.summary['classes']['copy/layout']['us'] / 1e3:.3f} ms", flush=True)
        shape_res["outputs_equal"] = bool(torch.equal(outs["default"], outs["prelaid"]))
        shape_res["finite"] = bool(torch.isfinite(outs["default"]).all())
        results["shapes"][skey] = shape_res
        del model
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace", default=None, help="write each profiled sampler call's Chrome trace under this directory")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(RUNS_DIR, "probe_layout_copies.json"))
    args = ap.parse_args(argv)
    from ..utils.hostmem import ensure_tuned

    ensure_tuned()  # glibc malloc tunables, by one re-exec of this command
    dev = measure_device(args.device)
    print(device_line(dev), flush=True)
    kw = {} if dev.type == "cuda" else dict(TINY, config_mv=tiny_config_mv())
    results = probe(dev, reps=args.reps, trace=args.trace, **kw)
    results["card"] = device_line(dev)
    print("wrote", write_json(args.out, results), flush=True)
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
