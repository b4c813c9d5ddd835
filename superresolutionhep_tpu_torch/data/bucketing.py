"""Length bucketing to a small set of padded shapes.

A copy of the JAX package's ``data/bucketing.py`` (numpy only; plans are
held equal to the JAX package's by a test).  The reference controls
attention memory with a greedy n^2-cost batch packer over per-batch max
lengths (threshold e.g. ``"3520**2 * 6"``).  Events are bucketed into a few
fixed pad lengths (multiples of ``quantum``, which the flash kernels need as
multiples of 128) and each bucket's batch is sized so that
``batch * pad_n^2 <= cost_budget`` — the same memory-control semantics with
a handful of shapes.

Incomplete final batches are padded with filler slots (index -1 -> fully
masked rows), keeping shapes static.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Bucket:
    pad_n: int
    batch_size: int


def make_buckets(
    counts: Sequence[int],
    quantum: int = 128,
    cost_budget: int | None = None,
    max_batch_size: int = 512,
    min_batch_size: int = 1,
    batch_multiple_of: int = 1,
    fine_quantum: int | None = None,
    fine_above: int = 0,
) -> List[Bucket]:
    """Derive bucket pad sizes covering the observed length distribution.

    ``batch_multiple_of`` rounds batch sizes up to a multiple of the data-mesh
    size so batches shard evenly across devices.

    ``fine_quantum``/``fine_above`` switch to a finer pad quantum for events
    longer than ``fine_above``: absolute padding waste in attention flops is
    ~2*N*pad per event, so it grows with N — a fine quantum at the top end
    buys most of the padding reduction for a handful of extra shapes, while
    short events keep the coarse quantum.
    """

    def _pad(n: int) -> int:
        q = fine_quantum if (fine_quantum is not None and n > fine_above) else quantum
        return int(np.ceil(n / q)) * q

    pad_sizes = sorted({_pad(n) for n in set(int(c) for c in counts)})
    if not pad_sizes:
        pad_sizes = [quantum]
    buckets = []
    m = max(1, batch_multiple_of)
    for pad_n in pad_sizes:
        if cost_budget is not None:
            bs = max(min_batch_size, min(max_batch_size, cost_budget // (pad_n * pad_n)))
        else:
            bs = max_batch_size
        # round DOWN to the mesh multiple so batch * pad_n^2 never exceeds the
        # memory budget; m is the floor when the budget allows fewer than m
        bs = max(m, (int(bs) // m) * m)
        buckets.append(Bucket(pad_n=pad_n, batch_size=int(bs)))
    return buckets


class BucketBatcher:
    """Assign events to buckets by padded length; iterate fixed-shape batches.

    Yields ``(indices, bucket)`` where ``indices`` is an int array of length
    ``bucket.batch_size`` with -1 for filler slots.
    """

    def __init__(
        self,
        counts: Sequence[int],
        quantum: int = 128,
        cost_budget: int | None = None,
        max_batch_size: int = 512,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
        batch_multiple_of: int = 1,
        tail_shrink: bool | str = False,
        fine_quantum: int | None = None,
        fine_above: int = 0,
        merge_tail_up: int = 0,
    ):
        # env vars and YAML both arrive as strings: normalize/validate so
        # "0" / "off" / "false" can't silently mean pow2 halving
        allowed = {False: False, True: "pow2", "pow2": "pow2", "exact": "exact",
                   "false": False, "off": False, "0": False, "none": False,
                   "true": "pow2", "1": "pow2"}
        key = tail_shrink.strip().lower() if isinstance(tail_shrink, str) else bool(tail_shrink)
        if key not in allowed:
            raise ValueError(
                f"tail_shrink={tail_shrink!r} not in {{False, True, 'pow2', 'exact'}}"
            )
        tail_shrink = allowed[key]
        # the flash kernel requires sequence lengths that are multiples of
        # its 128-lane block; a non-conforming fine quantum would build
        # bucket shapes the kernel rejects at dispatch time (the coarse
        # quantum is not gated here: CPU/einsum configs legitimately use 64)
        if fine_quantum is not None and fine_quantum % 128 != 0:
            raise ValueError(f"fine_quantum={fine_quantum} must be a multiple of 128")
        self.counts = np.asarray(counts, np.int64)
        self.buckets = make_buckets(
            self.counts, quantum, cost_budget, max_batch_size,
            batch_multiple_of=batch_multiple_of,
            fine_quantum=fine_quantum, fine_above=fine_above,
        )
        self.quantum = quantum
        self.shuffle = shuffle
        self.drop_last = drop_last
        # shrink the batch dim of each bucket's final underfilled batch:
        # filler slots are not free (the dense stack runs over every padded
        # row, the flash kernels still visit the masked tiles' flags).
        #   "pow2" (or True): halve down to the smallest power-of-two multiple
        #     that still fits — at most log2(B) extra shapes per bucket.
        #   "exact": ceil(n_real / batch_multiple_of) * batch_multiple_of —
        #     zero filler rows (up to the batch multiple).
        self.tail_shrink = tail_shrink
        self.batch_multiple_of = max(1, batch_multiple_of)
        # merge a bucket's underfilled tail UP into the next-larger bucket
        # when it holds <= merge_tail_up events: a 1-2 event batch pays the
        # fixed per-batch cost for almost no useful work; the moved events fit
        # the larger pad by construction.  0 = off.
        self.merge_tail_up = int(merge_tail_up)
        self._rng = np.random.default_rng(seed)

        pad_sizes = np.array([b.pad_n for b in self.buckets])
        # smallest bucket that fits each event
        self.event_bucket = np.searchsorted(pad_sizes, self.counts, side="left")

    def _plan(self, shuffle_events: bool) -> List[tuple[np.ndarray, Bucket]]:
        pools = []
        for bi in range(len(self.buckets)):
            idxs = np.nonzero(self.event_bucket == bi)[0]
            if shuffle_events:
                self._rng.shuffle(idxs)
            pools.append(idxs)
        if self.merge_tail_up:
            for bi in range(len(self.buckets) - 1):
                rem = len(pools[bi]) % self.buckets[bi].batch_size
                if 0 < rem <= self.merge_tail_up:
                    pools[bi + 1] = np.concatenate([pools[bi][-rem:], pools[bi + 1]])
                    pools[bi] = pools[bi][:-rem]
        batches = []
        for bi, bucket in enumerate(self.buckets):
            idxs = pools[bi]
            for s in range(0, len(idxs), bucket.batch_size):
                chunk = idxs[s : s + bucket.batch_size]
                if len(chunk) < bucket.batch_size:
                    # drop incomplete batches per bucket (matches __len__'s
                    # cnt // batch_size accounting, not global batch order)
                    if self.drop_last:
                        continue
                    bs = bucket.batch_size
                    if self.tail_shrink == "exact":
                        # exact fit, rounded up to the data-mesh multiple
                        m = self.batch_multiple_of
                        bs = min(bs, -(-len(chunk) // m) * m)
                    elif self.tail_shrink:
                        # shrunk sizes must stay multiples of the data-mesh
                        # size (halving 14 -> 7 would break even sharding)
                        m = self.batch_multiple_of
                        while bs // 2 >= len(chunk) and bs // 2 >= m and (bs // 2) % m == 0:
                            bs //= 2
                    chunk = np.concatenate(
                        [chunk, np.full(bs - len(chunk), -1, np.int64)]
                    )
                    batches.append((chunk, Bucket(bucket.pad_n, bs)))
                    continue
                batches.append((chunk, bucket))
        return batches

    def __iter__(self) -> Iterator[tuple[np.ndarray, Bucket]]:
        batches = self._plan(shuffle_events=self.shuffle)
        if self.shuffle:
            order = self._rng.permutation(len(batches))
            batches = [batches[i] for i in order]
        yield from batches

    def __len__(self) -> int:
        if self.merge_tail_up:
            # batch count depends on the merged pools, not per-bucket counts
            return len(self._plan(shuffle_events=False))
        n = 0
        for bi, bucket in enumerate(self.buckets):
            cnt = int((self.event_bucket == bi).sum())
            if self.drop_last:
                n += cnt // bucket.batch_size
            else:
                n += int(np.ceil(cnt / bucket.batch_size))
        return n
