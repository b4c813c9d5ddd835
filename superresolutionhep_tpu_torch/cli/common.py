"""Shared CLI plumbing: the JAX package's argument surface (training:
``-cmv``, ``-ct``, ``--run_dir``, ``--resume``, ``--profile``; inference:
``-i``, ``-bm``, ``-estart``, ``-estop``; both: ``--precision``,
``--device``) mapped onto PyTorch.  The training CLIs also take the
reference's ``-ekey/--exp_key`` and ``-d/--debug_mode``: the port has no
external logger, so both are accepted and change nothing."""

from __future__ import annotations

import argparse
import os

import torch


def _add_runtime_args(parser: argparse.ArgumentParser):
    parser.add_argument("--precision", "-p", type=str, default="default", choices=["default", "highest", "bfloat16"],
                        help="bfloat16: bf16 compute; default/highest: fp32 (TF32 off)")
    parser.add_argument("--device", "-g", type=str, default="cuda",
                        help="torch device; 'cuda' (default) raises where there is no GPU, 'cpu' runs on the CPU")


def add_train_args(parser: argparse.ArgumentParser):
    parser.add_argument("--config_mv", "-cmv", type=str, required=True)
    parser.add_argument("--config_t", "-ct", type=str, required=True)
    parser.add_argument("--exp_key", "-ekey", type=str, default=None,
                        help="experiment key of an external logger; accepted for the reference's surface, unused")
    parser.add_argument("--debug_mode", "-d", action="store_true",
                        help="local run without an external logger (the port has none: always so)")
    _add_runtime_args(parser)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--run_dir", type=str, default=None)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--profile", action="store_true",
                        help="trace the first trained epoch with torch.profiler into <run_dir>/profile")
    return parser


def add_inference_args(parser: argparse.ArgumentParser):
    parser.add_argument("--inference_path", "-i", type=str, required=True)
    parser.add_argument("--batch_mode", "-bm", action="store_true",
                        help="one entry range (-estart, -estop), output suffixed _{start}_{stop}")
    parser.add_argument("--entry_start", "-estart", type=int, default=0)
    parser.add_argument("--entry_stop", "-estop", type=int, default=None)
    _add_runtime_args(parser)
    return parser


def compute_dtype(precision: str):
    """``--precision`` -> the models' compute dtype (None: fp32)."""
    return torch.bfloat16 if precision == "bfloat16" else None


def default_run_dir(config_t: dict, kind: str) -> str:
    base = config_t.get("base_root_dir", "runs")
    name = f"{config_t.get('project_name', kind)}_{config_t.get('run_name', 'run')}"
    return os.path.join(base, name)
