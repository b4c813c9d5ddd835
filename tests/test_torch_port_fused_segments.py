"""PyTorch port, the per-segment modulation rows of the fused kernels K3/K4
(fp32, CPU, plain versions):

  * the gather that replaces the one-hot scatter (``ops/masked.py::
    gather_segment_rows``, ``models/dit.py::scatter_segments``) equals the
    einsum of the JAX package bit for bit on finite rows, padding and ids past
    the table included;
  * the segment form of each fused plain version equals the per-cell form on
    einsum-scattered rows bit for bit (padding cells, segment boundaries inside
    a 64-row tile), and so do its gradients (to 1e-6 relative: the gather's
    backward sums a segment's cells in another order than the einsum's);
  * one packed ``FlowModel`` forward with the fused prologue, whose DiT layers
    now hand per-segment tables to both fused wrappers, against the JAX packed
    model at the tolerance of ``test_torch_port_packed_model.py`` (1e-4 of the
    output's max).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from superresolutionhep_tpu.models.flow_model import FlowModel as JFlowModel
from superresolutionhep_tpu.ops import flash_packed as jfp
from superresolutionhep_tpu_torch.models.flow_model import FlowModel
from superresolutionhep_tpu_torch.ops import fused_mlp as tfm
from superresolutionhep_tpu_torch.ops import fused_qkv as tfq
from superresolutionhep_tpu_torch.ops.masked import gather_segment_rows, segment_onehot, segment_table
from superresolutionhep_tpu_torch.tools.convert import init_params_jax_layout, params_from_jax
from test_torch_port_packed_model import S, _events, _packed, _wide_config, make_configs

torch.set_num_threads(1)
GRAD_RTOL = 1e-6
PACKED_TOL = 1e-4


def _seg_rows(B=2, L=256, E=4):
    """Segment ids with boundaries inside 64-row tiles, padding between and
    after segments, and (row 1) an id past the table."""
    seg = np.full((B, L), -1, np.int32)
    seg[0, 0:37] = 0
    seg[0, 37:100] = 1      # boundary at 37, inside the first 64-row tile
    seg[0, 105:170] = 2     # padding 100..104 inside the second tile
    seg[0, 170:171] = 3     # a one-cell segment
    seg[1, 3:200] = 0
    seg[1, 200:230] = E + 2  # past the table: the zero row, as the one-hot gives
    return torch.from_numpy(seg)


def _einsum_rows(per_segment, seg):
    """The JAX package's per-cell broadcast: one-hot (S x E) product."""
    onehot = segment_onehot(seg, per_segment.shape[1], per_segment.dtype)
    return torch.einsum("bse,bef->bsf", onehot, per_segment)


def test_gather_equals_the_onehot_einsum():
    rng = np.random.default_rng(0)
    seg = _seg_rows()
    for dt in (torch.float32, torch.bfloat16, torch.float64):
        rows = torch.from_numpy(rng.normal(size=(2, 4, 24))).to(dt)
        got = gather_segment_rows(segment_table(rows), seg)
        assert got.dtype == dt and torch.equal(got, _einsum_rows(rows, seg))
    assert torch.equal(gather_segment_rows(segment_table(rows), seg)[seg < 0], torch.zeros(int((seg < 0).sum()), 24,
                                                                                             dtype=torch.float64))


def _tables(rng, B, E, F, n):
    return [torch.from_numpy((rng.normal(size=(B, E, F)) * 0.3 + (1.0 if i == 0 else 0.0)).astype(np.float32))
            for i in range(n)]


def _check_bitwise_and_grads(fn_seg, fn_cell, tables, others, seg):
    """fn_seg(tables with the zero row) against fn_cell(einsum-scattered rows):
    equal outputs, and gradients of every input within GRAD_RTOL."""
    tabs = [segment_table(t).requires_grad_(True) for t in tables]
    ins_s = [o.clone().requires_grad_(o.is_floating_point()) for o in others]
    out_s = fn_seg(tabs, ins_s)
    per_segment = [t.clone().requires_grad_(True) for t in tables]
    cells = [_einsum_rows(t, seg) for t in per_segment]
    ins_c = [o.clone().requires_grad_(o.is_floating_point()) for o in others]
    out_c = fn_cell(cells, ins_c)
    assert torch.equal(out_s, out_c)
    g = torch.from_numpy(np.random.default_rng(1).normal(size=out_s.shape).astype(np.float32))
    ga = torch.autograd.grad(out_s, tabs + ins_s, g)
    gb = torch.autograd.grad(out_c, per_segment + ins_c, g)
    for a, b in zip(ga, gb):
        a = a[:, :-1] if a.shape != b.shape else a  # a table's zero row has no counterpart
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=GRAD_RTOL * max(float(b.abs().max()), 1e-30))


def test_qkv_segment_form_equals_per_cell():
    rng = np.random.default_rng(2)
    B, L, F, E = 2, 256, 128, 4
    seg = _seg_rows(B, L, E)
    x = torch.from_numpy(rng.normal(size=(B, L, F)).astype(np.float32))
    w = torch.from_numpy((0.05 * rng.normal(size=(F, 3 * F))).astype(np.float32))
    bias = torch.from_numpy((0.1 * rng.normal(size=(3 * F,))).astype(np.float32))
    _check_bitwise_and_grads(
        lambda t, o: tfq.fused_ln_mod_proj(o[0], t[0], t[1], o[1], o[2], segment_ids=seg),
        lambda c, o: tfq.fused_ln_mod_proj(o[0], c[0], c[1], o[1], o[2]),
        _tables(rng, B, E, F, 2), [x, w, bias], seg)


def test_mlp_segment_form_equals_per_cell():
    rng = np.random.default_rng(3)
    B, L, F, Fh, E = 2, 256, 128, 256, 4
    seg = _seg_rows(B, L, E)
    q, att = (torch.from_numpy((0.5 * rng.normal(size=(B, L, F))).astype(np.float32)) for _ in range(2))
    w0 = torch.from_numpy((0.06 * rng.normal(size=(F, Fh))).astype(np.float32))
    w1 = torch.from_numpy((0.06 * rng.normal(size=(Fh, F))).astype(np.float32))
    b0 = torch.from_numpy((0.1 * rng.normal(size=(Fh,))).astype(np.float32))
    b1 = torch.from_numpy((0.1 * rng.normal(size=(F,))).astype(np.float32))
    ga, ea, eb, gm = _tables(rng, B, E, F, 4)
    _check_bitwise_and_grads(
        lambda t, o: tfm.fused_dit_mlp(o[0], o[1], t[0], t[1], t[2], t[3], *o[2:], segment_ids=seg),
        lambda c, o: tfm.fused_dit_mlp(o[0], o[1], c[0], c[1], c[2], c[3], *o[2:]),
        [ga, ea, eb, gm], [q, att, w0, b0, w1, b1], seg)


def test_packed_fused_flow_model_takes_segment_tables_and_matches_jax(monkeypatch):
    fm = _wide_config()
    mv, _ = make_configs(fm)
    events = _events(mv, 3, 23)
    _, hb = _packed(events)
    tree = init_params_jax_layout(fm, seed=4)
    t_val = 0.61
    saved = dict(jfp.PACKED_DEFAULTS)
    try:
        jfp.set_packed_defaults(block_q=128, block_k=128, max_segment_len=S)
        jmodel = JFlowModel(config=fm, attn_impl="flash", fused_prologue=True)
        jb = {k: jnp.asarray(v) for k, v in hb.items()}
        want = np.asarray(jax.jit(jmodel.apply)({"params": tree}, jb, jb["target"],
                                                jnp.full((1,), t_val, jnp.float32)))
    finally:
        jfp.PACKED_DEFAULTS.update(saved)
    seen = []
    qkv, mlp = tfq.fused_ln_mod_proj, tfm.fused_dit_mlp

    def spy_qkv(x, a, b, w, bias, segment_ids=None):
        seen.append(("qkv", tuple(a.shape), segment_ids is not None))
        return qkv(x, a, b, w, bias, segment_ids=segment_ids)

    def spy_mlp(*args, segment_ids=None):
        seen.append(("mlp", tuple(args[2].shape), segment_ids is not None))
        return mlp(*args, segment_ids=segment_ids)

    from superresolutionhep_tpu_torch.models import attention, dit

    monkeypatch.setattr(attention, "fused_ln_mod_proj", spy_qkv)
    monkeypatch.setattr(dit, "fused_dit_mlp", spy_mlp)
    model = FlowModel(fm, attn_impl="flash", fused_prologue=True)
    model.load_reference_state_dict(params_from_jax(tree, fm))
    tb = {k: torch.from_numpy(v) for k, v in hb.items()}
    with torch.no_grad():
        got = model(tb, tb["target"], torch.full((1,), t_val)).numpy()
    n_layers = fm["transformer"]["num_transformer_layers"]
    E1 = S // 128 + 1
    assert seen == [("qkv", (1, E1, 128), True), ("mlp", (1, E1, 128), True)] * n_layers
    assert np.abs(got - want).max() <= PACKED_TOL * float(np.abs(want).max())
