"""The bounded, stop-aware request channel.

Counterpart: ``alink_tpu/operator/stream/prefetch.py``. Only ``_Channel``
and its two markers are kept, for :class:`~alink_tpu_torch.serving.
server.PredictServer`'s admission queue, with the calls the server
makes: the consumer-side ``stop``, the depth gauge and the fault
injection site are left out with the stream, metrics and faults
layers.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

_SENTINEL = object()
# timed-get miss marker (serving micro-batcher): distinct from the
# end-of-stream sentinel so "nothing arrived within the latency budget"
# and "the stream is over" stay distinguishable
_EMPTY = object()


class _Channel:
    """Bounded FIFO channel with close-aware blocking.

    ``put`` blocks while the channel is full and wakes when it is
    closed; ``get`` blocks until an item or the sentinel arrives. One
    lock + two conditions; unbounded when ``maxsize <= 0``."""

    def __init__(self, maxsize: int):
        self._buf: deque = deque()
        self._maxsize = maxsize
        self._lock = threading.Lock()
        self._not_full = threading.Condition(self._lock)
        self._not_empty = threading.Condition(self._lock)
        self._closed = False

    def put(self, item) -> bool:
        """Enqueue; False when the channel is already closed (a
        producer racing ``close()`` must not strand an item no getter
        will ever see — the serving tier's submit-vs-shutdown race)."""
        with self._not_full:
            while not self._closed and self._maxsize > 0 \
                    and len(self._buf) >= self._maxsize:
                self._not_full.wait()
            if self._closed:
                return False
            self._buf.append(item)
            self._not_empty.notify()
            return True

    def get(self, timeout: Optional[float] = None):
        """Dequeue one item; blocks until an item, close
        (``_SENTINEL``) or — when ``timeout`` is given — the deadline
        (``_EMPTY``). ``timeout=0`` polls without blocking."""
        deadline = None if timeout is None \
            else time.monotonic() + max(0.0, timeout)
        with self._not_empty:
            while not self._buf:
                if self._closed:
                    return _SENTINEL
                if deadline is None:
                    self._not_empty.wait()
                    continue
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return _EMPTY
                self._not_empty.wait(remaining)
            item = self._buf.popleft()
            self._not_full.notify()
            return item

    def drain(self, max_items: int) -> list:
        """Pop up to ``max_items`` buffered items under ONE lock
        acquisition (never blocks; [] when empty) — the micro-batcher's
        bulk path."""
        with self._lock:
            k = min(int(max_items), len(self._buf))
            if k <= 0:
                return []
            items = [self._buf.popleft() for _ in range(k)]
            self._not_full.notify_all()
            return items

    def close(self) -> None:
        """Producer end-of-stream: buffered items still DRAIN to getters;
        once empty, every get() returns the sentinel."""
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()   # blocked producers must re-check
