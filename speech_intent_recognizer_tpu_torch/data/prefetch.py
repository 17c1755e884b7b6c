"""Host-to-device prefetch and host-side decode overlap.

Counterpart of ``speech_intent_recognizer_tpu/data/prefetch.py``:

* :func:`device_prefetch` keeps ``buffer_size`` batches in flight: each is
  copied from pinned host memory with ``non_blocking=True`` on a side CUDA
  stream while the card runs the step on the batch before (the JAX
  package's ``jax.device_put`` is asynchronous by itself; the reference's
  unused ``GPUPrefetcher``, ``scripts/testing.py:283-327``, is this
  design);
* :class:`BackgroundLoader` runs a producer on a worker thread, its items
  consumed in order.  One change from the original: an exception raised by
  the producer is re-raised in the consumer (the original would wait for
  the dead worker forever).
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Iterable, Iterator

import numpy as np
import torch
from torch.utils._pytree import tree_leaves, tree_map


def device_prefetch(iterator: Iterable, buffer_size: int = 2,
                    device: "str | torch.device | None" = None) -> Iterator:
    """Wrap a host batch iterator; yield its batches on ``device`` in
    order, the next ``buffer_size`` already on their way.

    A batch is a pytree (tuples, lists, dicts) of tensors and NumPy arrays;
    arrays become tensors.  On a CUDA device each is copied from pinned
    memory with ``non_blocking=True`` on a side stream; before a batch is
    yielded the consumer's stream waits for the side stream and each
    tensor is recorded on the consumer's stream, so the caching allocator
    keeps its memory until the consumer's work on it is done.  On any other
    device it is a plain pass-through (``.to(device)``)."""
    dev = torch.device(device) if device is not None else None
    cuda = dev is not None and dev.type == "cuda"

    def move(a):
        if isinstance(a, np.ndarray):
            a = torch.from_numpy(a)
        if not isinstance(a, torch.Tensor) or dev is None:
            return a
        if not cuda:
            return a.to(dev)
        return (a.pin_memory() if a.device.type == "cpu" else a).to(
            dev, non_blocking=True)

    if not cuda:
        for batch in iterator:
            yield tree_map(move, batch)
        return
    side = torch.cuda.Stream(dev)
    queue: collections.deque = collections.deque()

    def put(batch):
        with torch.cuda.stream(side):
            queue.append(tree_map(move, batch))

    it = iter(iterator)
    for batch in it:
        put(batch)
        if len(queue) >= buffer_size:
            break
    while queue:
        out = queue.popleft()
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_stream(side)
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                t.record_stream(consumer)
        for batch in it:
            put(batch)
            break
        yield out


class BackgroundLoader:
    """Run a host-side batch producer on a worker thread (decode overlap).

    The reference parallelized decoding with 8 DataLoader worker processes
    (configs/config.yaml:22-26); here one background thread suffices because
    decode is native C++ releasing the GIL in I/O, and the device path is
    asynchronous.  A producer exception reaches the consumer.
    """

    def __init__(self, producer: Callable[[], Iterable], capacity: int = 4):
        self._producer = producer
        self._capacity = capacity

    def __iter__(self):
        queue: collections.deque = collections.deque()
        done = threading.Event()
        lock = threading.Condition()
        failure: list = []

        def work():
            try:
                for item in self._producer():
                    with lock:
                        while (len(queue) >= self._capacity
                               and not done.is_set()):
                            lock.wait(0.1)
                        if done.is_set():
                            return
                        queue.append(item)
                        lock.notify_all()
            except Exception as e:  # re-raised in the consumer below
                failure.append(e)
            finally:
                done.set()
                with lock:
                    lock.notify_all()

        t = threading.Thread(target=work, daemon=True)
        t.start()
        try:
            while True:
                with lock:
                    while not queue and not done.is_set():
                        lock.wait(0.1)
                    if queue:
                        item = queue.popleft()
                        lock.notify_all()
                    elif failure:
                        raise failure[0]
                    elif done.is_set():
                        return

                yield item
        finally:
            done.set()
            with lock:
                lock.notify_all()
            t.join()
