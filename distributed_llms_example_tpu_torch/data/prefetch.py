"""Background-thread batch prefetching (the port's own copy of the JAX
package's ``data/prefetch.py``).

Batch assembly (tokenize, pad, bucket) is numpy and tokenizer work on the
host; a thread runs it ahead of the train step, so it overlaps the step's
enqueue instead of sitting between steps.

``Prefetcher`` wraps any iterator: a daemon thread fills a bounded queue
``depth`` items ahead; a producer's exception is raised again in the
consumer at the point of failure; ``close()`` (or ``with``, or garbage
collection) stops the producer promptly.  ``stats()`` reports the items
delivered and the wall time the consumer spent blocked on the queue: the
per-run answer to "is the input pipeline on the critical path?".
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Any, Iterable, Iterator

_DONE = object()


class Prefetcher:
    def __init__(self, it: Iterable, depth: int = 2):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._err: BaseException | None = None
        self._finished = False  # latched: never block on the queue again
        self._items = 0  # items handed to the consumer
        self._wait_s = 0.0  # wall time the consumer spent blocked on get()
        self._thread = threading.Thread(target=self._fill, args=(iter(it),), daemon=True)
        self._thread.start()

    def _fill(self, it: Iterator) -> None:
        try:
            for item in it:
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except BaseException as e:  # noqa: BLE001 - raised again in the consumer
            self._err = e
        # _err is set before the consumer can see _DONE (the queue orders them)
        while not self._stop.is_set():
            try:
                self._q.put(_DONE, timeout=0.1)
                return
            except queue.Full:
                continue

    def __iter__(self) -> "Prefetcher":
        return self

    def __next__(self) -> Any:
        # latched: the producer is gone, so another get() would block forever
        if self._finished:
            if self._err is not None:
                raise self._err
            raise StopIteration
        t0 = time.perf_counter()
        item = self._q.get()
        self._wait_s += time.perf_counter() - t0
        if item is _DONE:
            self._finished = True
            if self._err is not None:
                raise self._err
            raise StopIteration
        self._items += 1
        return item

    def stats(self) -> dict:
        """``{"items", "consumer_wait_s"}``: the items delivered and the wall
        time the consumer spent blocked waiting for one.  A wait near the
        first item's assembly time means the thread hid the rest; a wait
        growing with the items means the producer cannot keep up."""
        return {"items": self._items, "consumer_wait_s": self._wait_s}

    def close(self) -> None:
        self._finished = True
        self._stop.set()
        # drain, so a producer blocked on a full queue sees the stop
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass

    def __enter__(self) -> "Prefetcher":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def __del__(self) -> None:
        if hasattr(self, "_thread"):  # not when __init__ refused its arguments
            self.close()
