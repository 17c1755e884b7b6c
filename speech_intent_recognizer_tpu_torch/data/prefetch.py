"""Host-side decode overlap for the feature precompute.

Copy of ``BackgroundLoader`` from
``speech_intent_recognizer_tpu/data/prefetch.py``: a producer runs on a
worker thread and its items are consumed in order.  One change: an
exception raised by the producer is re-raised in the consumer (the original
would wait for the dead worker forever).
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, Iterable


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
