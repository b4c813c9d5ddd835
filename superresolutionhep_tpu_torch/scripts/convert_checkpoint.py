"""Convert between the reference's Lightning checkpoints and the port's.

The port's counterpart of the JAX package's ``scripts/convert_torch_checkpoint.py``
and ``scripts/export_torch_checkpoint.py``; the direction follows the input:

  * a reference Lightning ``.ckpt`` becomes the port's own checkpoint (a
    ``.pt`` holding the reference-layout ``state_dict``, which
    ``train/checkpoint.py::load_params`` reads and every ``model.checkpoint_path``
    of the port accepts);
  * anything else ``load_params`` reads (a Flax ``.msgpack`` blob such as
    ``saved_checkpoints/closure_sr/params.msgpack``, or a checkpoint of the
    port's trainer) becomes a Lightning ``.ckpt`` in the reference's exact
    ``net.*`` layout, loadable by the reference's ``inference.py`` /
    ``inference_pf.py`` with ``load_state_dict(strict=True)``.  Only
    reference-schema architectures export: ``fourier_features`` has no
    counterpart in the reference and is refused.

Either way the weights are loaded strictly into the port's model of
``--config`` before anything is written.

    python -m superresolutionhep_tpu_torch.scripts.convert_checkpoint --kind pf \
        --input saved_checkpoints/pf_lr/epoch=...ckpt --config config_mv.yml --out pf_lr.pt
    python -m superresolutionhep_tpu_torch.scripts.convert_checkpoint --kind sr \
        --input params.msgpack --config model_and_var.yml --out model.ckpt
"""

from __future__ import annotations

import argparse
import os

import torch


def check_loads(state_dict, config_mv: dict, kind: str):
    """Load ``state_dict`` strictly into the port's model of ``config_mv``
    (raises on a missing, unexpected or misshapen tensor)."""
    if kind == "sr":
        from ..models.flow_model import FlowModel

        FlowModel(config_mv["flow_model"]).load_reference_state_dict(state_dict, strict=True)
    else:
        from ..models.pf import SAPF
        from ..transforms import build_var_transforms

        model = SAPF(config_mv["pf_model"], transforms=build_var_transforms(config_mv["var_transform"]),
                     inference=True)
        model.load_reference_state_dict(state_dict, strict=True)


def lightning_to_port(ckpt_path: str, config_mv: dict, kind: str, out: str) -> str:
    from ..tools.lightning import load_lightning_checkpoint

    state_dict, _ = load_lightning_checkpoint(ckpt_path)
    check_loads(state_dict, config_mv, kind)
    torch.save({"state_dict": state_dict}, out)
    return out


def to_lightning(params_path: str, config_mv: dict, kind: str, out: str, epoch: int = 0) -> str:
    from ..tools.lightning import save_lightning_checkpoint
    from ..train.checkpoint import load_reference_params

    model_cfg = config_mv["flow_model" if kind == "sr" else "pf_model"]
    if kind == "sr":
        for emb_key in ("etaphi_emb", "e_proxy_emb", "noisy_input_emb"):
            if model_cfg.get(emb_key, {}).get("fourier_features"):
                raise SystemExit(f"flow_model.{emb_key}.fourier_features has no counterpart in the reference's "
                                 "model; cannot export")
    state_dict = load_reference_params(params_path, model_cfg, kind)
    check_loads(state_dict, config_mv, kind)
    return save_lightning_checkpoint(state_dict, out, hyper_parameters={}, epoch=epoch)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--kind", choices=["sr", "pf"], required=True)
    ap.add_argument("--input", required=True,
                    help="a reference Lightning .ckpt, or a .msgpack blob / port checkpoint")
    ap.add_argument("--config", required=True, help="model_and_var.yml")
    ap.add_argument("--out", required=True, help="the port's .pt (from a .ckpt), else a Lightning .ckpt")
    ap.add_argument("--epoch", type=int, default=0, help="the epoch recorded in a written .ckpt")
    args = ap.parse_args(argv)

    from ..config import load_yaml

    cfg = load_yaml(args.config)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    if args.input.endswith(".ckpt"):
        out = lightning_to_port(args.input, cfg, args.kind, args.out)
    else:
        out = to_lightning(args.input, cfg, args.kind, args.out, epoch=args.epoch)
    print(f"converted {args.input} -> {out}")
    return out


if __name__ == "__main__":
    main()
