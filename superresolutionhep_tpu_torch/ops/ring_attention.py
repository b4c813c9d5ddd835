"""Ring attention over a sequence-parallel group.

Counterpart of the JAX package's ``ops/ring_attention.py``: instead of
gathering K/V (O(N) memory per rank, one large collective) the K/V shards
rotate round the group (``parallel/comm.py::ppermute``) while each rank
accumulates its own queries' online-softmax state, O(N/n) K/V memory.  The
same online softmax as the JAX version: ``NEG_INF`` on masked keys, fp32
logits, fp32 running max, sum and accumulator, the final division by
max(l, 1e-30) and the query mask on the output.  The per-step arithmetic is
plain torch, as the JAX version's is einsum: there is no kernel here.

Used by ``models/attention.py::MultiheadAttention`` with ``sp_mode='ring'``
(the default ``'gather'`` gathers K/V and runs the flash kernel).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..parallel.comm import ppermute

NEG_INF = -1e30


def ring_masked_attention(q, k, v, q_valid, kv_valid, scale: float, group):
    """q, k, v: (B, L_local, H, D) shards of the ``group``'s token axis; masks
    (B, L_local) True==valid or None.  Returns (B, Lq_local, H, D) in q's
    dtype."""
    n = dist.get_world_size(group)
    B, Lq, H, D = q.shape
    dev = q.device
    m = torch.full((B, H, Lq, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, Lq, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, Lq, D), dtype=torch.float32, device=dev)
    kvm = torch.ones(k.shape[:2], dtype=torch.float32, device=dev) if kv_valid is None else kv_valid.float()
    qf = q.float()  # bf16 products are exact in fp32: JAX's preferred_element_type=float32
    for step in range(n):
        s = torch.einsum("bqhd,bkhd->bhqk", qf, k.float()) * scale
        s = torch.where(kvm[:, None, None, :] > 0, s, torch.full((), NEG_INF, device=dev))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype), v)
        m = m_new
        if step < n - 1:  # the JAX scan's n-th rotation only brings the shards home
            k, v, kvm = ppermute(k, group), ppermute(v, group), ppermute(kvm, group)
    out = (acc / l.clamp_min(1e-30)).permute(0, 2, 1, 3)  # (B, Lq, H, D)
    if q_valid is not None:
        out = out * q_valid[:, :, None, None]
    return out.to(q.dtype)
