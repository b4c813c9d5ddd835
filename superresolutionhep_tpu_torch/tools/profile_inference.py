"""Wall-time attribution of one SR model evaluation at the two extreme
production bucket shapes, (64, 1536) and (10, 5120): attention against
everything else.

Counterpart of the JAX package's ``tools/profile_inference.py``, with its
fields.  The multipart model at full width (h 256, 6 DiT layers, 4 heads of
64) computes in bf16 from fp32 weights drawn from a seed, robust (``attn_impl``
auto: the running-max kernel K1) and no-max (K2), unfused.  Per shape and
variant:

  * ``model_eval_ms``: ``N_EVAL_CHAIN`` = 20 chained evaluations run eagerly
    with one synchronisation per chain (two chains of warm-up, then ``reps``),
    per evaluation, so it holds the host's launch time too;
    ``model_device_ms``: the device time of one more such chain under
    ``torch.profiler`` per evaluation (``tools/trace_summary.py``), beside it;
  * ``attention_ms``: the model's attention calls alone (6 per evaluation),
    20 evaluations' worth chained in one CUDA graph (``scripts/common.py::
    graph_ms``) on the pre-folded entry (``masked_flash_attention_T`` with q
    scaled once per call by a device constant and fp32 masks made once: the
    public entry's host-built scale constant cannot be captured);
  * ``other_ms`` = model_eval_ms - attention_ms, the attention share, and the
    flop rates from ``tools/flops.py::flow_model_flops``.

One evaluation per variant and shape runs first, alone, under ``checked()``
(a context-manager factory; ``chip_smoke.py`` passes its launch checker).

    python -m superresolutionhep_tpu_torch.tools.profile_inference [--reps 4] [--trace DIR] [--out PATH]

Prints the card's name and power limit, then one JSON line per shape;
writes the whole result to ``--out`` (default under ``runs/``).  ``--device
cpu`` (the tests) runs the tiny sizes of ``TINY``.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import time

import numpy as np
import torch

from ..configs import MULTIPART_CONFIG_MV
from ..models.flow_model import FlowModel
from ..ops.flash_attention import LOG2E, masked_flash_attention_T
from ..scripts.common import RUNS_DIR, chained_ms, device_line, measure_device, sync, tiny_config_mv, write_json
from .convert import init_params_jax_layout, params_from_jax
from .flops import flow_model_flops
from .trace_summary import ProfiledWindow

SHAPES = [(64, 1536), (10, 5120)]  # production bucket extremes
N_EVAL_CHAIN = 20  # model evaluations chained per timed segment
TINY = {"shapes": [(2, 256)], "n_eval_chain": 2}  # --device cpu, with tiny_config_mv()


def make_batch(B, L, rng, dev):
    """The JAX tool's random batch: normal features, layers 0-2, every cell valid."""
    f32 = lambda: torch.from_numpy(rng.normal(size=(B, L, 1)).astype(np.float32)).to(dev)  # noqa: E731
    return {"eta": f32(), "cosphi": f32(), "sinphi": f32(),
            "layer": torch.from_numpy(rng.integers(0, 3, size=(B, L, 1)).astype(np.int32)).to(dev),
            "e_proxy": f32(), "q_mask": torch.ones((B, L), dtype=torch.bool, device=dev)}


def random_model(config_mv, dev, **kw):
    """The ``FlowModel`` with random weights from seed 0 (the JAX package's
    init policy, ``tools/convert.py``), in eval mode without gradients."""
    fm = config_mv["flow_model"]
    model = FlowModel(fm, **kw)
    model.load_reference_state_dict(params_from_jax(init_params_jax_layout(fm, seed=0), fm))
    return model.to(dev).eval().requires_grad_(False)


@torch.no_grad()
def profile(dev, reps=4, shapes=SHAPES, n_eval_chain=N_EVAL_CHAIN, config_mv=MULTIPART_CONFIG_MV, trace=None,
            checked=contextlib.nullcontext, windows=None):
    """The attribution at each shape; ``windows`` (a list) collects each
    profiled window (``trace_summary.ProfiledWindow``)."""
    config_mv = copy.deepcopy(config_mv)
    tcfg = config_mv["flow_model"]["transformer"]
    n_layers, H = int(tcfg["num_transformer_layers"]), int(tcfg["num_heads"])
    D = int(config_mv["flow_model"]["h_dim"]) // H
    results = {"device": str(dev), "n_eval_chain": n_eval_chain, "reps": reps, "shapes": {}}
    rng = np.random.default_rng(0)
    for B, L in shapes:
        key = f"{B}x{L}"
        batch = make_batch(B, L, rng, dev)
        shape_res = {}
        for fast in (False, True):
            name = "fast" if fast else "robust"
            model = random_model(config_mv, dev, attn_impl="flash_nomax" if fast else "auto", dtype=torch.bfloat16)
            ts = torch.linspace(0.0, 1.0, n_eval_chain, device=dev)
            x0 = torch.zeros((B, L, 1), dtype=torch.float32, device=dev)

            def model_chain():
                x = x0
                for i in range(n_eval_chain):
                    v = model(batch, x, ts[i].expand(B))
                    x = x + 0.01 * v.to(x.dtype)
                return x

            with checked():
                model(batch, x0, ts[0].expand(B))
            for _ in range(2):  # first-call set-up, then a warm chain
                model_chain()
                sync(dev)
            t0 = time.time()
            for _ in range(reps):
                out = model_chain()
            sync(dev)
            t_model = (time.time() - t0) / reps / n_eval_chain
            trace_path = os.path.join(trace, f"{key}_{name}.json") if trace else None
            with ProfiledWindow(dev, f"profile_inference {key} {name} model chain", trace_path) as w:
                model_chain()
            if windows is not None:
                windows.append(w)

            # the model's attention calls alone: n_layers per evaluation, chained
            qkv = torch.from_numpy(rng.normal(size=(B, L, H, D)).astype(np.float32)).to(dev, torch.bfloat16)
            mask = torch.ones((B, L), dtype=torch.float32, device=dev)
            c = torch.tensor(0.125 * LOG2E, dtype=torch.bfloat16, device=dev)
            kT = qkv.permute(0, 2, 3, 1)
            smode = "nomax_clip" if fast else "max"

            def attn_chain():
                o = qkv
                for _ in range(n_eval_chain * n_layers):
                    oT = masked_flash_attention_T((o * c).permute(0, 2, 3, 1), kT, kT, mask, mask, softmax=smode)
                    o = oT.permute(0, 3, 1, 2)
                return o

            t_attn = chained_ms(attn_chain, dev, reps) / 1e3 / n_eval_chain
            f = flow_model_flops(model, config_mv, B, L)
            shape_res[name] = {
                "model_eval_ms": round(1e3 * t_model, 2),
                # from the profiled chain; not measured on the CPU
                "model_device_ms": w.summary["kernel_us"] / 1e3 / n_eval_chain if dev.type == "cuda" else None,
                "model_busy_share": w.summary["busy_share"] if dev.type == "cuda" else None,
                "attention_ms": round(1e3 * t_attn, 2),
                "other_ms": round(1e3 * (t_model - t_attn), 2),
                "attention_frac_of_wall": round(t_attn / t_model, 3),
                "attention_tfs": round(f["attention"] / t_attn / 1e12, 1),
                "model_tfs": round(f["total"] / t_model / 1e12, 1),
                "flops_per_eval_attention": f["attention"],
                "flops_per_eval_total": f["total"],
                "finite": bool(torch.isfinite(out).all()),
            }
            del model
        results["shapes"][key] = shape_res
        print(key, json.dumps(shape_res), flush=True)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trace", default=None, help="write each profiled model chain's Chrome trace under this directory")
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(RUNS_DIR, "profile_inference.json"))
    args = ap.parse_args(argv)
    dev = measure_device(args.device)
    print(device_line(dev), flush=True)
    kw = {} if dev.type == "cuda" else dict(TINY, config_mv=tiny_config_mv())
    results = profile(dev, reps=args.reps, trace=args.trace, **kw)
    results["card"] = device_line(dev)
    print("wrote", write_json(args.out, results), flush=True)
    return results


if __name__ == "__main__":
    main()
