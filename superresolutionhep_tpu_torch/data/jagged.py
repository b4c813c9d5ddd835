"""Jagged (variable-length-per-event) array containers.

The reference keeps per-event variable-length arrays as numpy object arrays
read through uproot/awkward.  Here a flat buffer + offsets representation is
used — contiguous, zero-copy sliceable, and directly mappable to both the
uproot awkward layout and our HDF5 container.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, List, Sequence

import numpy as np


@dataclass
class JaggedArray:
    """Variable-length rows: row i is flat[offsets[i]:offsets[i+1]]."""

    flat: np.ndarray
    offsets: np.ndarray  # (n_rows + 1,), int64

    @classmethod
    def from_list(cls, rows: Sequence[np.ndarray], dtype=None) -> "JaggedArray":
        counts = np.fromiter((len(r) for r in rows), dtype=np.int64, count=len(rows))
        offsets = np.zeros(len(rows) + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
        if len(rows):
            flat = np.concatenate([np.asarray(r).ravel() for r in rows])
        else:
            flat = np.empty(0, dtype or np.float32)
        if dtype is not None:
            flat = flat.astype(dtype)
        return cls(flat, offsets)

    def __len__(self) -> int:
        return len(self.offsets) - 1

    def __getitem__(self, i: int) -> np.ndarray:
        return self.flat[self.offsets[i] : self.offsets[i + 1]]

    @property
    def counts(self) -> np.ndarray:
        return np.diff(self.offsets)

    def to_list(self) -> List[np.ndarray]:
        return [self[i] for i in range(len(self))]

    def select(self, indices: Iterable[int]) -> "JaggedArray":
        return JaggedArray.from_list([self[i] for i in indices], dtype=self.flat.dtype)

    def map(self, fn) -> "JaggedArray":
        return JaggedArray(fn(self.flat), self.offsets.copy())


@dataclass
class Jagged2Array:
    """Doubly-jagged rows (e.g. per-particle lists of cell indices).

    Row i has ``outer_offsets[i+1]-outer_offsets[i]`` inner lists; inner list j
    of row i is
    ``flat[inner_offsets[outer_offsets[i]+j] : inner_offsets[outer_offsets[i]+j+1]]``.
    """

    flat: np.ndarray
    inner_offsets: np.ndarray
    outer_offsets: np.ndarray

    @classmethod
    def from_list(cls, rows: Sequence[Sequence[np.ndarray]], dtype=None) -> "Jagged2Array":
        inner_lists = [np.asarray(x).ravel() for row in rows for x in row]
        inner = JaggedArray.from_list(inner_lists, dtype=dtype)
        outer_counts = np.fromiter((len(r) for r in rows), np.int64, count=len(rows))
        outer_offsets = np.zeros(len(rows) + 1, np.int64)
        np.cumsum(outer_counts, out=outer_offsets[1:])
        return cls(inner.flat, inner.offsets, outer_offsets)

    def __len__(self) -> int:
        return len(self.outer_offsets) - 1

    def __getitem__(self, i: int) -> List[np.ndarray]:
        lo, hi = self.outer_offsets[i], self.outer_offsets[i + 1]
        return [
            self.flat[self.inner_offsets[j] : self.inner_offsets[j + 1]] for j in range(lo, hi)
        ]
