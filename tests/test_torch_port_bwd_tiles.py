"""PyTorch port, the host side of the bf16 flash-attention backward (K5, K6,
K8, K9), which the CPU reaches without the card:

  * the band tables of the packed backward (``packed_band``'s plain version
    at the backward's tiles) in both directions: dq's key tiles per query
    block and dk/dv's query tiles per key block, which are the same table
    because queries and keys share the segment ids.  Each is held against a
    brute-force scan of the same-segment pair mask (padding included: a pair
    of padding cells matches, but its cotangent is zero, so only pairs of a
    valid segment are live) at every tile height ``bwd_tile_rows`` can pick:
    every live pair lies in its block's band, and the band's first and last
    tiles each hold one (the band is exact); and against the JAX package's
    ``band_ranges``, with the roles of queries and keys swapped for dk/dv;
  * the wrappers' plan as a pure function: the tile height, grids and
    threads, the lse/dl row stride and the TMA maps of q, k, v and the
    cotangent at the training shapes;
  * that the plan refuses a view the TMA cannot take, and that the launch
    operands then hold a contiguous copy (and padded lse/dl rows);
  * that the packed wrappers hand both kernels the band table of the block
    height they launch with.
"""

import numpy as np
import pytest
import torch

from superresolutionhep_tpu.ops import flash_packed as jfp
from superresolutionhep_tpu_torch.data.packing import pack_events
from superresolutionhep_tpu_torch.ops import flash_attention as fa
from superresolutionhep_tpu_torch.ops import flash_packed as tfp

torch.set_num_threads(1)
H100_SMS = 132
TILE_ROWS = (64, 128)  # what bwd_tile_rows can pick


def _packed_seg(lens, S, rows):
    """Segment ids of the first batch ``pack_events`` makes of ``lens``, as
    ``collate_packed`` numbers them (by offset within a row, -1 on padding)."""
    seg = np.full((rows, S), -1, np.int32)
    for b, row in enumerate(pack_events(lens, S=S, rows_per_batch=rows)[0].rows):
        for sid, (_, off, n) in enumerate(sorted(row, key=lambda r: r[1])):
            seg[b, off: off + n] = sid
    return seg


def _layouts(S):
    """Packed rows with segments ending inside 64-cell tiles, a row of one
    long segment, rows with boundaries inside tiles and gaps of padding, and
    a row of padding only."""
    packed = _packed_seg([S - 300, 130, 51, 333, S, 64, 200, S // 2 - 20], S, 5)
    extra = np.full((3, S), -1, np.int32)
    extra[0, :300], extra[0, 300:584], extra[0, 584:S - 100] = 0, 1, 2
    extra[1, 10:70], extra[1, 200:S - 37] = 0, 1
    return np.concatenate([packed, extra])


def _brute_force(seg, rows, bt):
    """Per (batch row, block of ``rows`` cells): the first and last
    ``bt``-cell tile of the other axis that holds a cell pairing with a valid
    cell of the block (same segment, padding included in the scan), or None."""
    out = []
    for b in range(seg.shape[0]):
        same = seg[b][:, None] == seg[b][None, :]  # the kernels' pair mask: padding matches padding
        live = same & (seg[b][:, None] >= 0)        # pairs of a valid segment (padding's cotangent is zero)
        row = []
        for r0 in range(0, seg.shape[1], rows):
            cells = np.flatnonzero(live[r0: r0 + rows].any(0))
            row.append((cells.min() // bt, cells.max() // bt) if cells.size else None)
        out.append(row)
    return out


@pytest.mark.parametrize("S", [1536, 640])
def test_bwd_band_tables_exact_both_directions_and_match_jax(S):
    seg = _layouts(S)
    bt = fa.BWD_BLOCK_T
    assert any(0 < (np.flatnonzero(r >= 0).max() + 1) % bt for r in seg if (r >= 0).any()), "no segment ends in a tile"
    for rows in TILE_ROWS:
        band = tfp.packed_band(torch.from_numpy(seg), rows, bt).numpy()
        assert band.shape == (seg.shape[0], S // rows, 2)
        want = _brute_force(seg, rows, bt)
        for b in range(seg.shape[0]):
            for blk, w in enumerate(want[b]):
                first, count = band[b, blk]
                if w is None:
                    assert count == 0, (rows, b, blk)
                else:
                    assert (first, first + count - 1) == w, (rows, b, blk, band[b, blk], w)
            # dq: every live (query, key) pair lies in the query block's band
            # of key tiles; dk/dv: the same pair, read from the key's side,
            # lies in the key block's band of query tiles
            q, k = np.nonzero((seg[b][:, None] == seg[b][None, :]) & (seg[b][:, None] >= 0))
            for own, other in ((q, k), (k, q)):
                first, count = band[b, own // rows, 0], band[b, own // rows, 1]
                assert np.all((other // bt >= first) & (other // bt < first + count)), (rows, b)
        # the JAX package's band_ranges(seg, BQ, BK): query blocks of BQ over
        # key tiles of BK (dq); with the roles swapped, its first tiling is
        # the key blocks and its second the query tiles (dk/dv), and since
        # both axes carry the same ids that is the same call
        start, cnt = jfp.band_ranges(seg, rows, bt)
        np.testing.assert_array_equal(band[..., 0], np.asarray(start), err_msg=f"rows={rows}")
        np.testing.assert_array_equal(band[..., 1], np.asarray(cnt), err_msg=f"rows={rows}")


def _fused_views(B, L, F, H):
    qkv = torch.empty((B, L, 3 * F), dtype=torch.bfloat16)
    return [qkv[..., i * F:(i + 1) * F].view(B, L, H, F // H) for i in range(3)]


SHAPES = (  # (B, L, F, H): bucketed training, the packed batch, the ragged kernel case, small grids, a D = 32 model
    (8, 2048, 256, 4), (6, 3584, 256, 4), (8, 5120, 256, 4), (10, 2048, 256, 4), (4, 256, 64, 4), (2, 1024, 128, 4),
)


def test_bwd_plan_tile_rows_and_tensor_maps():
    picked = set()
    for B, L, F, H in SHAPES:
        D = F // H
        q, k, v = _fused_views(B, L, F, H)
        g = torch.empty((B, L, H, D), dtype=torch.bfloat16)  # the cotangent as _flash_bwd hands it on
        plan = fa.bwd_plan(q, k, v, g, H100_SMS)
        rows = 128 if B * H * -(-L // 128) >= 2 * H100_SMS else 64
        for kind in ("dq", "dkv"):
            assert plan[kind]["block_rows"] == fa.bwd_tile_rows(B, H, L, H100_SMS) == rows
            assert plan[kind]["grid"] == (-(-L // rows), H, B)
            assert plan[kind]["threads"] == 128 * (rows // 64) + (32 if kind == "dq" else 0)
        picked.add(rows)
        assert plan["block_t"] == 64 and plan["rows_stride"] == L
        for name in ("q", "k", "v", "g"):
            m = plan["maps"][name]
            assert m["dims"] == (D, L, H, B)
            row_bytes = 2 * D * H if name == "g" else 3 * F * 2
            assert m["strides_bytes"] == (row_bytes, D * 2, L * row_bytes)
            assert m["box"] == (D, 64, 1, 1)
            assert m["swizzle_bytes"] == 2 * D
    assert picked == set(TILE_ROWS)
    # the training shapes take the two-warpgroup blocks
    assert all(fa.bwd_tile_rows(B, 4, L, H100_SMS) == 128 for B, L in ((8, 2048), (6, 3584), (8, 5120)))
    # Lq != Lk: each kernel's blocks follow its own axis
    q = torch.empty((2, 640, 4, 64), dtype=torch.bfloat16)
    k = torch.empty((2, 8192, 4, 64), dtype=torch.bfloat16)
    plan = fa.bwd_plan(q, k, k, q, H100_SMS)
    assert (plan["dq"]["block_rows"], plan["dkv"]["block_rows"]) == (64, 128)
    assert plan["dq"]["grid"] == (10, 4, 2) and plan["dkv"]["grid"] == (64, 4, 2)


def test_bwd_plan_refuses_views_the_tma_cannot_take_and_copies_them():
    B, L, H, D = 2, 602, 4, 64  # L no multiple of 4: lse/dl rows padded to 604
    q, k, v = (t[:, :L] for t in _fused_views(B, 640, H * D, H))
    g = torch.randn(B, 1, H, D).to(torch.bfloat16).expand(B, L, H, D)  # a broadcast cotangent
    odd = torch.empty((B, L, 3 * 256 + 4), dtype=torch.bfloat16)  # a row stride of 1544 bytes
    bad = {
        "broadcast (stride 0)": g,
        "head dim not contiguous": q.transpose(1, 3).contiguous().transpose(1, 3),
        "row stride not a multiple of 16 bytes": odd[..., :256].view(B, L, H, D),
        "base not 16-byte aligned": torch.empty(B * L * H * D + 4, dtype=torch.bfloat16)[4:].view(B, L, H, D),
        "float32": q.float(),
    }
    for what, t in bad.items():
        assert not fa.tensor_map_ok(t), what
        with pytest.raises(ValueError):
            fa.tensor_map_plan(t)
    with pytest.raises(ValueError):
        fa.bwd_plan(q, k, v, g, H100_SMS)
    assert fa.bwd_rows_stride(L) == 604 and fa.bwd_rows_stride(640) == 640
    lse, dl = torch.randn(B, H, L), torch.randn(B, H, L)
    out = fa._bwd_launch_operands(q, k, v, g, lse, dl, None, L, H100_SMS)
    q2, k2, v2, g2, lse2, dl2, rows, ldr = out
    assert q2 is q and k2 is k and v2 is v  # views the TMA takes are passed as they are
    assert fa.tensor_map_ok(g2) and g2.is_contiguous() and torch.equal(g2, g)
    assert ldr == 604 and rows == fa.bwd_tile_rows(B, H, L, H100_SMS) == 64
    for got, want in ((lse2, lse), (dl2, dl)):
        assert got.shape == (B, H, 604) and got.is_contiguous() and torch.equal(got[..., :L], want)
    # fp32 operands go to the fp32 kernels as they are (unpadded rows, no tile height)
    qf = torch.randn(B, L, H, 16)
    out = fa._bwd_launch_operands(qf, qf, qf, qf, lse, dl, None, L, H100_SMS)
    assert out[4] is lse and out[5] is dl and out[6:] == (0, L)


def test_packed_launch_operands_carry_the_band_table_of_the_block_height(monkeypatch):
    monkeypatch.setattr(tfp, "sm_count", lambda dev: H100_SMS)
    seg = torch.from_numpy(_layouts(1536))
    B, S, H, D = seg.shape[0], seg.shape[1], 4, 32
    qkv = torch.zeros((B, S, 3, H, D), dtype=torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    g = torch.zeros((B, S, H, D), dtype=torch.bfloat16)
    lse, dl = torch.zeros((B, H, S)), torch.zeros((B, H, S))
    for rows in (None, 64, 128):
        *_, band, got_rows, ldr = tfp._packed_bwd_cuda_operands(q, k, v, g, lse, dl, seg, rows)
        want_rows = rows or fa.bwd_tile_rows(B, H, S, H100_SMS)
        assert got_rows == want_rows and ldr == S
        # one table for both kernels: key tiles per query block (dq) and
        # query tiles per key block (dk/dv), at the kernels' block height
        assert torch.equal(band, tfp._ref_packed_band(seg, want_rows, fa.BWD_BLOCK_T))
    *_, band, rows, ldr = tfp._packed_bwd_cuda_operands(q.float(), k.float(), v.float(), g.float(), lse, dl, seg, None)
    assert band is None and rows == 0 and ldr == S  # the fp32 kernels find their band per block
