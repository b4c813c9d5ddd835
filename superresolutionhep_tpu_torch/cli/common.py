"""Shared CLI plumbing: the JAX package's argument surface (``-cmv``,
``-ct``, ``--precision``, ``--device``, ``--run_dir``, ``--resume``,
``--profile``) mapped onto PyTorch."""

from __future__ import annotations

import argparse
import os

import torch


def add_train_args(parser: argparse.ArgumentParser):
    parser.add_argument("--config_mv", "-cmv", type=str, required=True)
    parser.add_argument("--config_t", "-ct", type=str, required=True)
    parser.add_argument("--precision", "-p", type=str, default="default", choices=["default", "highest", "bfloat16"],
                        help="bfloat16: bf16 compute with fp32 parameters; default/highest: fp32 (TF32 off)")
    parser.add_argument("--device", "-g", type=str, default="cuda",
                        help="torch device; 'cuda' (default) raises where there is no GPU, 'cpu' runs on the CPU")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--run_dir", type=str, default=None)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--profile", action="store_true",
                        help="trace the first trained epoch with torch.profiler into <run_dir>/profile")
    return parser


def compute_dtype(precision: str):
    """``--precision`` -> the models' compute dtype (None: fp32)."""
    return torch.bfloat16 if precision == "bfloat16" else None


def default_run_dir(config_t: dict, kind: str) -> str:
    base = config_t.get("base_root_dir", "runs")
    name = f"{config_t.get('project_name', kind)}_{config_t.get('run_name', 'run')}"
    return os.path.join(base, name)
