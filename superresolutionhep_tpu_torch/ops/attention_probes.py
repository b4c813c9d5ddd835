"""Attention-forward probes: the kernels of the two measuring scripts
(``scripts/kernel_experiments.py`` and ``scripts/probe_exp_dtype.py`` of this
package), hand-written for Hopper in ``csrc/attention_probes.cu`` on the
shipped bf16 forward body (``csrc/flash_fwd.cuh``, the body of K1/K2/K7).

Two entries, each with its own launch counter:
  * ``attention_variant`` (``probe_variant``, K10): unmasked attention in one
    of four modes (``MODES``) that take attention apart: the two products
    alone, exp without the running max, the full online softmax with the
    exponential in bf16, and the same in fp32;
  * ``attention_exp_probe`` (``probe_exp_dtype``, K11): the online softmax
    with an additive key mask ``(km - 1) * 1e30``, exp in bf16 or fp32.

Both take q, k, v (B, H, L, D) bf16, D = 64, the RAW logits q k^T going
straight into exp2 (no scale), and a tile shape (``block_q`` query rows x
``block_k`` keys, one of ``TILES``: the shipped body's query tiles, 64 or 192
rows, times 64 keys, and 192 x 128; ``block_q`` defaults to the shipped forward's
pick for the shape, ``flash_attention.fwd_tile_rows``; L a multiple of
``block_k``, not necessarily of ``block_q``).  The plain versions beside
them repeat the kernels' arithmetic cast for cast and mirror their key
blocking (the bf16 rounding of p depends on where the running max stood at
each key block), so they take ``block_k`` too.  On a CPU tensor a wrapper
computes its plain version; on a CUDA tensor it launches its kernel or
raises.
"""

from __future__ import annotations

import torch

from . import kernels
from .flash_attention import FWD_ROWS_PER_WARPGROUP, FWD_TMA_ROWS, fwd_tile_rows, sm_count, tensor_map_plan

MODES = ("matmuls_only", "no_max", "full", "fp32_exp")
# the (query rows, keys) tile shapes the CUDA source instantiates (64 x 128
# spilled in the masked modes at its 128 registers a thread: not built)
TILES = ((64, 64), (192, 64), (192, 128))
BLOCK_K = 64  # the shipped forward's key tile: the default
HEAD_DIM = 64
BIG = 1e30
NEG_INF = -1e30


def _ref_probe(q, k, v, km, mode: str, block_k: int):
    """Plain version of both kernels.  q, k, v (B, H, L, D); km (B, L) float
    or None.  Key blocks of ``block_k``, with the TPU kernels' per-block
    carry of m, l, acc in fp32."""
    if mode not in MODES:
        raise ValueError(f"unknown probe mode {mode!r}; one of {MODES}")
    B, H, L, D = q.shape
    qf = q.float()
    m = torch.full((B, H, L, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, L, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, L, D), dtype=torch.float32, device=q.device)
    for j in range(0, L, block_k):
        kb, vb = k[:, :, j: j + block_k].float(), v[:, :, j: j + block_k].float()
        s = torch.matmul(qf, kb.transpose(-1, -2))
        if km is not None:
            s = s + (km[:, None, None, j: j + block_k].float() - 1.0) * BIG
        if mode == "matmuls_only":
            acc = acc + torch.matmul(s.to(v.dtype).float(), vb)
            continue
        if mode == "no_max":
            p = torch.exp2(s.to(torch.bfloat16))
            l = l + p.float().sum(-1, keepdim=True)
            acc = acc + torch.matmul(p.to(v.dtype).float(), vb)
            continue
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        if mode == "full":
            p = torch.exp2((s - m_new).to(torch.bfloat16))
            p_sum = p.float().sum(-1, keepdim=True)
        else:
            p = torch.exp2(s - m_new)
            p_sum = p.sum(-1, keepdim=True)
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p_sum
        acc = acc * alpha + torch.matmul(p.to(v.dtype).float(), vb)
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def _ref_variant(q, k, v, mode: str, block_k: int = BLOCK_K):
    """Plain version of K10."""
    return _ref_probe(q, k, v, None, mode, block_k)


def _ref_exp_probe(q, k, v, km, exp_bf16: bool, block_k: int = BLOCK_K):
    """Plain version of K11; km (B, L) float."""
    return _ref_probe(q, k, v, km, "full" if exp_bf16 else "fp32_exp", block_k)


def probe_plan(q, k, v, block_q: int = None, block_k: int = BLOCK_K, sms: int = None) -> dict:
    """The probe kernels' launch on (B, H, L, D) contiguous bf16 tensors, as
    ``csrc/attention_probes.cu`` makes it, and the checks of what the kernels
    take (ValueError otherwise).  ``block_q`` None: the shipped forward's
    pick for the shape on a card of ``sms`` SMs (192 rows at 128 keys, the
    one height built there).  Returns the tile, the
    consumer warpgroups NC, the grid, threads and dynamic shared memory of a
    block, the K/V ring's stages, and the three TMA tensor maps, which are
    read through the (B, L, H, D) views ``t.transpose(1, 2)``."""
    B, H, L, D = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or t.device != q.device or tuple(t.shape) != (B, H, L, D):
            raise ValueError(f"attention probe: {name} must be bfloat16 {(B, H, L, D)} on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"attention probe: {name} must be contiguous (B, H, L, D)")
    if D != HEAD_DIM:
        raise ValueError(f"attention probe kernels are built for D={HEAD_DIM}, got {D}")
    if max(B, H) > 65535:
        raise ValueError(f"attention probe: B={B}, H={H} exceed the grid's 65535")
    if block_q is None:  # the shipped forward's pick, or the one height built for block_k
        block_q = fwd_tile_rows(B, H, L, sms)
        heights = [bq for bq, bk in TILES if bk == block_k]
        if heights and block_q not in heights:
            block_q = heights[0]
    if (block_q, block_k) not in TILES or L % block_k:
        raise ValueError(f"attention probe: tile ({block_q}, {block_k}) must be one of {TILES}, "
                         f"its key width dividing L={L}")
    nc = block_q // FWD_ROWS_PER_WARPGROUP
    stages = 3 if nc == 1 else 5
    tile_bytes = FWD_TMA_ROWS * D * 2
    smem = (1024 + (nc + 2 * stages * (block_k // FWD_TMA_ROWS)) * tile_bytes + stages * block_k * 4 + 32
            + (2 * stages + 1) * 8)
    return {"block_q": block_q, "block_k": block_k, "nc": nc, "grid": (-(-L // block_q), H, B),
            "threads": 128 * (nc + 1), "stages": stages, "smem_bytes": smem,
            "maps": {name: tensor_map_plan(t.transpose(1, 2)) for name, t in (("q", q), ("k", k), ("v", v))}}


def _launch_plan(q, k, v, block_q, block_k):
    q, k, v = (t.contiguous() for t in (q, k, v))
    return (q, k, v), probe_plan(q, k, v, block_q, block_k, sm_count(q.device) if block_q is None else None)


def attention_variant(q, k, v, mode: str, block_q: int = None, block_k: int = BLOCK_K):
    """K10: q, k, v (B, H, L, 64) bf16 -> out (B, H, L, 64) bf16 in ``mode``."""
    if not q.is_cuda:
        return _ref_variant(q, k, v, mode, block_k)
    if mode not in MODES:
        raise ValueError(f"unknown probe mode {mode!r}; one of {MODES}")
    (q, k, v), plan = _launch_plan(q, k, v, block_q, block_k)
    B, H, L, D = q.shape
    out = torch.empty_like(q)
    lib = kernels.library()
    with torch.cuda.device(q.device):
        rc = lib.srhep_probe_variant(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H, L, D,
                                     MODES.index(mode), plan["block_q"], block_k,
                                     torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(rc, "probe_variant")
    kernels.LAUNCHES["probe_variant"] += 1
    return out


def attention_exp_probe(q, k, v, km, exp_bf16: bool, block_q: int = None, block_k: int = BLOCK_K):
    """K11: q, k, v (B, H, L, 64) bf16, km (B, L) float (1 = valid) -> out
    (B, H, L, 64) bf16; exp2 in bf16 (``exp_bf16``) or in fp32."""
    if not q.is_cuda:
        return _ref_exp_probe(q, k, v, km, exp_bf16, block_k)
    (q, k, v), plan = _launch_plan(q, k, v, block_q, block_k)
    B, H, L, D = q.shape
    if km.device != q.device or km.dtype != torch.float32 or tuple(km.shape) != (B, L):
        raise ValueError(f"attention probe: km must be float32 {(B, L)} on {q.device}")
    km = km.contiguous()
    out = torch.empty_like(q)
    lib = kernels.library()
    with torch.cuda.device(q.device):
        rc = lib.srhep_probe_exp_dtype(q.data_ptr(), k.data_ptr(), v.data_ptr(), km.data_ptr(), out.data_ptr(),
                                       B, H, L, D, int(bool(exp_bf16)), plan["block_q"], block_k,
                                       torch.cuda.current_stream(q.device).cuda_stream)
    kernels.check(rc, "probe_exp_dtype")
    kernels.LAUNCHES["probe_exp_dtype"] += 1
    return out
