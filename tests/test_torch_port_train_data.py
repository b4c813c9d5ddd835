"""PyTorch port, the training data pipeline against the JAX package: the
bucket batcher's plans (buckets, batches, per-epoch shuffles) are equal, and
the prefetcher delivers in order and re-raises a failed item's error."""

import threading
import time

import numpy as np
import pytest

from superresolutionhep_tpu.data.bucketing import BucketBatcher as JBucketBatcher
from superresolutionhep_tpu.data.prefetch import BatchPrefetcher as JBatchPrefetcher
from superresolutionhep_tpu_torch.data.bucketing import BucketBatcher
from superresolutionhep_tpu_torch.data.prefetch import BatchPrefetcher


@pytest.mark.parametrize("opts", [
    dict(quantum=256, cost_budget=3520**2 * 6, max_batch_size=64, shuffle=True, seed=3),
    dict(quantum=128, max_batch_size=5, shuffle=False),
    dict(quantum=128, cost_budget=2048**2 * 4, max_batch_size=16, shuffle=True, seed=1, tail_shrink="exact",
         batch_multiple_of=2),
    dict(quantum=128, max_batch_size=8, shuffle=True, seed=2, tail_shrink=True, merge_tail_up=2, drop_last=False),
    dict(quantum=64, max_batch_size=4, shuffle=True, seed=4, drop_last=True, fine_quantum=128, fine_above=1000),
])
def test_bucket_batcher_plans_equal(opts):
    counts = np.random.default_rng(0).integers(1, 4800, size=300)
    jb, tb = JBucketBatcher(counts, **opts), BucketBatcher(counts, **opts)
    assert tb.buckets == [type(tb.buckets[0])(b.pad_n, b.batch_size) for b in jb.buckets]
    assert len(tb) == len(jb)
    for _epoch in range(2):  # the shuffle state carries over between epochs
        got, want = list(tb), list(jb)
        assert len(got) == len(want)
        for (gi, gbk), (wi, wbk) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            assert (gbk.pad_n, gbk.batch_size) == (wbk.pad_n, wbk.batch_size)


def test_prefetcher_order_and_errors():
    def prepare(i):
        time.sleep(0.002 * ((7 * i) % 5))  # later items often finish first
        if i == 13:
            raise KeyError("item 13")
        return i * i

    for cls in (BatchPrefetcher, JBatchPrefetcher):
        assert list(cls(range(12), prepare, num_workers=4)) == [i * i for i in range(12)]
        assert list(cls(range(6), prepare, num_workers=0)) == [i * i for i in range(6)]
        it = cls(range(20), prepare, num_workers=3)
        got = []
        with pytest.raises(KeyError):
            for x in it:
                got.append(x)
        assert got == [i * i for i in range(13)]
        with pytest.raises(KeyError):  # the same error again, never a silent stop
            next(it)
    assert threading.active_count() < 50
