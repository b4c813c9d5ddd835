"""Fixed-shape event packing for segment-packed inference and training.

Counterpart of the JAX package's ``data/packing.py`` (numpy, the same
layouts and batches bit for bit): events are packed back to back into rows
of one static length S, each event aligned to 128 cells, with a per-cell
segment id.  First-fit decreasing over the aligned lengths.  Oversize events
(aligned length > S) are rejected at pack time; the inference driver routes
them to the bucketed path.

The attention contract (ops/flash_packed.py): valid segment ids are
nondecreasing along each row, padding cells carry -1.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..ops.flash_packed import SEG_ALIGN as ALIGN


def aligned_len(n: int, align: int = ALIGN) -> int:
    return -(-n // align) * align


@dataclasses.dataclass
class PackedBatch:
    """Layout of one (rows, S) packed batch."""

    rows: List[List[Tuple[int, int, int]]]  # per row: (event_idx, offset, n_cells)

    @property
    def n_events(self) -> int:
        return sum(len(r) for r in self.rows)


def pack_events(
    cell_counts: Sequence[int],
    S: int = 5120,
    rows_per_batch: int = 8,
    align: int = ALIGN,
) -> List[PackedBatch]:
    """First-fit-decreasing packing of events into (rows_per_batch, S)
    batches; the final batch is padded with empty rows."""
    if align < ALIGN or align % ALIGN:
        # the model bounds the segments of a row by S // SEG_ALIGN
        # (models/flow_model.py); packing more finely would overflow it
        raise ValueError(f"align={align} must be a multiple of {ALIGN}")
    counts = np.asarray(cell_counts)
    if counts.size == 0:
        return []
    order = np.argsort(-counts)  # decreasing
    rows: List[Tuple[int, List[Tuple[int, int, int]]]] = []  # (used, items)
    for idx in order:
        n = int(counts[idx])
        a = aligned_len(n, align)
        if a > S:
            raise ValueError(f"event {idx} has {n} cells; aligned {a} > S={S}")
        for ri, (used, items) in enumerate(rows):
            if used + a <= S:
                items.append((int(idx), used, n))
                rows[ri] = (used + a, items)
                break
        else:
            rows.append((a, [(int(idx), 0, n)]))

    batches = []
    all_rows = [items for _, items in rows]
    for i in range(0, len(all_rows), rows_per_batch):
        chunk = all_rows[i : i + rows_per_batch]
        while len(chunk) < rows_per_batch:
            chunk.append([])
        batches.append(PackedBatch(rows=chunk))
    return batches


HIGH_KEYS_F32 = ("eta", "cosphi", "sinphi", "e_proxy", "target")


def collate_packed(events, batch_layout: PackedBatch, S: int) -> Dict[str, np.ndarray]:
    """The packed model batch of one PackedBatch: the per-cell feature keys of
    ``collate`` plus ``seg`` ((B, S) int32, -1 padding); segment ids number
    the events of a row in offset order.  ``events`` is indexable by the event
    indices of the layout."""
    B = len(batch_layout.rows)
    out: Dict[str, np.ndarray] = {}
    for k in HIGH_KEYS_F32:
        out[k] = np.zeros((B, S, 1), np.float32)
    out["layer"] = np.zeros((B, S, 1), np.int32)
    out["q_mask"] = np.zeros((B, S), bool)
    out["seg"] = np.full((B, S), -1, np.int32)

    for bi, row in enumerate(batch_layout.rows):
        for si, (ev_idx, off, n) in enumerate(sorted(row, key=lambda t: t[1])):
            ev = events[ev_idx]
            for k in HIGH_KEYS_F32:
                if k in ev.high:
                    out[k][bi, off : off + n, 0] = ev.high[k]
            out["layer"][bi, off : off + n, 0] = ev.high["layer"]
            out["q_mask"][bi, off : off + n] = True
            out["seg"][bi, off : off + n] = si
    return out
