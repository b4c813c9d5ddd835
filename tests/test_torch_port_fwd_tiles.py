"""PyTorch port, the host side of the bf16 flash-attention forward (K1, K2,
K7), which the CPU reaches without the card:

  * the band table of the packed kernel (``packed_band``'s plain version) at
    the kernel's tile sizes against the JAX package's ``band_ranges`` at the
    same sizes, on ``data/packing.py`` layouts whose segments end inside key
    tiles and on a row with segment boundaries inside tiles; and, by brute
    force in numpy, that every same-segment (query, key) pair lies in its
    query tile's band and that the band's first and last tiles hold such a
    pair (the band is exact), also with a ragged last query tile;
  * the wrapper's plan as a pure function: the tile height it picks, and the
    TMA tensor maps (dims, byte strides, box, swizzle) it would encode for
    the fused (B, L, 3F) projection views of the serve and packed shapes;
  * that the plan refuses a view the TMA cannot take.
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


def _packed_seg(lens, S, rows):
    """Segment ids of the first batch ``pack_events`` makes of ``lens``, as
    ``collate_packed`` numbers them (by offset within a row, -1 on padding)."""
    seg = np.full((rows, S), -1, np.int32)
    for b, row in enumerate(pack_events(lens, S=S, rows_per_batch=rows)[0].rows):
        for sid, (_, off, n) in enumerate(sorted(row, key=lambda r: r[1])):
            seg[b, off: off + n] = sid
    return seg


def _layouts():
    S = 1536  # a multiple of 64, 128 and 192: the JAX band_ranges takes every tile height here
    packed = _packed_seg([700, 130, 51, 1000, 333, 1536, 64, 200], S, 6)
    inside = np.full((2, S), -1, np.int32)  # boundaries inside 64-cell tiles, a gap of padding
    inside[0, :300], inside[0, 300:584], inside[0, 584:1000], inside[0, 1100:1530] = 0, 1, 2, 3
    return np.concatenate([packed, inside])


def _brute_force_bands(seg, bq, bk):
    """Per (row, query tile): the first and last key tile holding a key of the
    same segment as one of the tile's valid queries, or None."""
    B, S = seg.shape
    out = []
    for b in range(B):
        row = []
        for q0 in range(0, S, bq):
            ids = {int(x) for x in seg[b, q0: q0 + bq] if x >= 0}
            keys = np.flatnonzero(np.isin(seg[b], list(ids))) if ids else np.array([], int)
            row.append((keys.min() // bk, keys.max() // bk) if keys.size else None)
        out.append(row)
    return out


@pytest.mark.parametrize("ragged", [False, True], ids=["S1536", "ragged_last_tile"])
def test_band_table_exact_and_matches_jax(ragged):
    seg = _layouts()
    if ragged:  # S = 1024: no multiple of 192, so the last 192-row query tile is ragged
        seg = np.ascontiguousarray(seg[:, :1024])
    bk = fa.FWD_BLOCK_K
    assert any(0 < (np.flatnonzero(r >= 0).max() + 1) % bk for r in seg if (r >= 0).any()), "no segment ends inside a tile"
    for bq in (64, 192):
        band = tfp.packed_band(torch.from_numpy(seg), bq).numpy()
        assert band.shape == (seg.shape[0], -(-seg.shape[1] // bq), 2)
        if seg.shape[1] % bq == 0:
            ks, kc = jfp.band_ranges(seg, bq, bk)
            np.testing.assert_array_equal(band[..., 0], np.asarray(ks))
            np.testing.assert_array_equal(band[..., 1], np.asarray(kc))
        for b, row in enumerate(_brute_force_bands(seg, bq, bk)):
            for qt, want in enumerate(row):
                first, count = band[b, qt]
                if want is None:
                    assert count == 0, (b, qt)
                else:
                    assert (first, first + count - 1) == want, (bq, b, qt, band[b, qt], want)
        # every same-segment pair of valid cells lies in its query tile's band
        for b in range(seg.shape[0]):
            q, k = np.nonzero((seg[b][:, None] == seg[b][None, :]) & (seg[b][:, None] >= 0))
            first, count = band[b, q // bq, 0], band[b, q // bq, 1]
            assert np.all((k // bk >= first) & (k // bk < first + count))


def _fused_views(B, L, F, H):
    qkv = torch.empty((B, L, 3 * F), dtype=torch.bfloat16)
    return [qkv[..., i * F:(i + 1) * F].view(B, L, H, F // H) for i in range(3)]


SHAPES = (  # (B, L, F, H): the serve buckets (10 members), the packed batch, PF's bf16 step, a D = 32 model
    (10, 512, 256, 4), (10, 2048, 256, 4), (10, 4096, 256, 4), (8, 5120, 256, 4), (4, 256, 64, 4), (2, 1024, 128, 4),
)


def test_plan_tile_rows_and_tensor_maps():
    picked = set()
    for B, L, F, H in SHAPES:
        D = F // H
        q, k, v = _fused_views(B, L, F, H)
        plan = fa.fwd_plan(q, k, v, H100_SMS)
        rows = 192 if B * H * -(-L // 192) >= 2 * H100_SMS else 64
        assert plan["block_q"] == fa.fwd_tile_rows(B, H, L, H100_SMS) == rows
        picked.add(rows)
        assert plan["grid"] == (-(-L // rows), H, B)
        assert plan["threads"] == 128 * (rows // 64 + 1)
        assert plan["block_k"] == 64
        for name in ("q", "k", "v"):
            m = plan["maps"][name]
            assert m["dims"] == (D, L, H, B)
            assert m["strides_bytes"] == (3 * F * 2, D * 2, L * 3 * F * 2)
            assert m["box"] == (D, 64, 1, 1)
            assert m["swizzle_bytes"] == 2 * D
    assert picked == {64, 192}


def test_plan_refuses_views_the_tma_cannot_take():
    q, k, v = _fused_views(2, 512, 256, 4)
    assert fa.tensor_map_plan(q)["swizzle_bytes"] == 128
    odd = torch.empty((2, 512, 3 * 256 + 4), dtype=torch.bfloat16)  # a row stride of 1544 bytes
    bad = {
        "head dim not contiguous": q.transpose(1, 3).contiguous().transpose(1, 3),
        "row stride not a multiple of 16 bytes": odd[..., :256].view(2, 512, 4, 64),
        "base not 16-byte aligned": torch.empty(2 * 512 * 4 * 64 + 4, dtype=torch.bfloat16)[4:].view(2, 512, 4, 64),
        "float32": q.float(),
        "head dim 48": torch.empty((2, 512, 4, 48), dtype=torch.bfloat16),
    }
    for what, t in bad.items():
        with pytest.raises(ValueError):
            fa.tensor_map_plan(t)
            pytest.fail(f"accepted: {what}")
