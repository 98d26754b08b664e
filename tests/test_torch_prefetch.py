"""The port's ``data/prefetch.py`` ``Prefetcher``, the JAX package's
``tests/test_prefetch.py`` cases on the port's copy: order kept, a
producer's exception raised again in the consumer (and again after it,
not a hang), producer and consumer overlapped, ``close()`` stopping the
producer, ``stats()`` locating the blocking side; and the trainer's epoch
batches the same with prefetch on as off."""

import time

import numpy as np
import pytest

from distributed_llms_example_tpu_torch.data.batching import BatchIterator
from distributed_llms_example_tpu_torch.data.dataset import CausalLMDataset
from distributed_llms_example_tpu_torch.data.prefetch import Prefetcher
from distributed_llms_example_tpu_torch.data.tokenizer import ByteTokenizer


def test_prefetcher_preserves_order():
    with Prefetcher(iter(range(100)), depth=3) as pf:
        assert list(pf) == list(range(100))


def test_prefetcher_propagates_exception():
    def gen():
        yield 1
        yield 2
        raise RuntimeError("producer blew up")

    pf = Prefetcher(gen(), depth=2)
    assert next(pf) == 1
    assert next(pf) == 2
    with pytest.raises(RuntimeError, match="producer blew up"):
        next(pf)
    with pytest.raises(RuntimeError, match="producer blew up"):  # latched, no hang
        next(pf)


def test_prefetcher_overlaps_producer_and_consumer():
    n, t = 10, 0.03

    def slow_producer():
        for i in range(n):
            time.sleep(t)
            yield i

    start = time.perf_counter()
    for _ in Prefetcher(slow_producer(), depth=2):
        time.sleep(t)  # consumer work
    elapsed = time.perf_counter() - start
    serial = 2 * n * t
    assert elapsed < serial * 0.8, f"no overlap: {elapsed:.3f}s vs serial {serial:.3f}s"


def test_prefetcher_close_stops_producer():
    produced = []

    def gen():
        for i in range(1000):
            produced.append(i)
            yield i

    pf = Prefetcher(gen(), depth=2)
    assert next(pf) == 0
    pf.close()
    time.sleep(0.2)
    n_after_close = len(produced)
    time.sleep(0.2)
    assert len(produced) == n_after_close, "producer kept running after close()"
    assert n_after_close < 1000
    with pytest.raises(StopIteration):
        next(pf)


def test_prefetch_stats_locate_the_blocking_side():
    def slow_producer():
        for i in range(10):
            time.sleep(0.02)
            yield i

    pf = Prefetcher(slow_producer(), depth=2)
    assert list(pf) == list(range(10))
    s = pf.stats()
    assert s["items"] == 10 and s["consumer_wait_s"] > 0.1  # producer-bound

    pf = Prefetcher(iter(range(10)), depth=2)
    got = []
    for x in pf:
        time.sleep(0.005)  # consumer-bound: the producer is always ahead
        got.append(x)
    s = pf.stats()
    assert got == list(range(10)) and s["items"] == 10 and s["consumer_wait_s"] < 0.05
    with pytest.raises(ValueError, match="depth"):
        Prefetcher(iter(()), depth=0)


def test_prefetched_epoch_equals_the_epoch():
    rng = np.random.RandomState(0)
    recs = [{"dialogue": "x" * rng.randint(3, 60), "summary": "y" * rng.randint(1, 9)}
            for _ in range(20)]
    it = BatchIterator(CausalLMDataset(recs, ByteTokenizer(), max_length=64), global_batch=4,
                       seed=3, bucket_multiple=16, max_source_length=64, max_target_length=64)
    want = list(it.epoch(1, start_step=1))
    with Prefetcher(it.epoch(1, start_step=1), depth=2) as pf:
        got = list(pf)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert all(np.array_equal(g[k], w[k]) for k in w)
