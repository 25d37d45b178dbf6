"""The loaders' background thread (the DataLoader-worker equivalent): it
makes the next items on the host while the consumer runs the device's
step."""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, TypeVar

T = TypeVar("T")

DEPTH = 2           # items the thread keeps ready


def prefetch(make_item: Callable[[int], T], n: int,
             depth: int = DEPTH) -> Iterator[T]:
    """``make_item(0)``, ..., ``make_item(n - 1)``, made in order by a
    background thread up to ``depth`` ahead of the consumer; an exception
    raised there is raised in the consumer."""
    q: queue.Queue = queue.Queue(maxsize=depth)

    def producer():
        try:
            for i in range(n):
                q.put(make_item(i))
        except Exception as e:  # handed to the consumer, raised there
            q.put(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    for _ in range(n):
        item = q.get()
        if isinstance(item, Exception):
            raise item
        yield item
    t.join()
