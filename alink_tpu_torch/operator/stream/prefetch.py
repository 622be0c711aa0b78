"""The bounded, stop-aware channel and the one-thread run-ahead.

Counterpart: ``alink_tpu/operator/stream/prefetch.py``. Ported:
``_Channel`` with its two markers (:class:`~alink_tpu_torch.serving.
server.PredictServer`'s admission queue, and the channel under
:func:`prefetch`) and :func:`prefetch`, which ``StreamOperator.execute``
and the FTRL trainer's drain use. Left out: ``prefetch_map`` and its
worker pool, the env knobs (the depth is fixed at ``PREFETCH_DEPTH``),
the depth gauge and the fault injection site.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Iterable, Iterator, Optional, TypeVar

T = TypeVar("T")

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
        self._stopped = False

    def put(self, item) -> bool:
        """Enqueue; False when the consumer has stopped or the channel
        is already closed (a producer racing ``close()`` must not
        strand an item no getter will ever see — the serving tier's
        submit-vs-shutdown race)."""
        with self._not_full:
            while not self._closed and not self._stopped \
                    and self._maxsize > 0 \
                    and len(self._buf) >= self._maxsize:
                self._not_full.wait()
            if self._closed or self._stopped:
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
                if self._closed or self._stopped:
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

    def stop(self) -> None:
        """Consumer abandonment: wake every blocked producer and
        consumer at once and discard buffered items."""
        with self._lock:
            self._stopped = True
            self._buf.clear()
            self._not_full.notify_all()
            self._not_empty.notify_all()


PREFETCH_DEPTH = 2


def prefetch(it: Iterable[T]) -> Iterator[T]:
    """Iterate ``it`` in one background thread, ``PREFETCH_DEPTH`` items
    ahead.

    Order is kept exactly; the bound is the backpressure (the thread
    blocks while the consumer is behind); an exception of the upstream
    iterator re-raises at the consumer where its item would have come.
    A consumer that stops early (or raises) stops the thread, which
    closes the upstream iterator."""
    ch = _Channel(PREFETCH_DEPTH)
    err: list = []

    def worker():
        try:
            for item in it:
                if not ch.put((item,)):
                    break
        except BaseException as e:      # re-raised at the consumer
            err.append(e)
        finally:
            close = getattr(it, "close", None)
            if close is not None:
                try:
                    close()
                except BaseException as e:
                    err.append(e)
            ch.close()

    th = threading.Thread(target=worker, daemon=True,
                          name="alink-prefetch-0")
    th.start()
    try:
        while True:
            item = ch.get()
            if item is _SENTINEL:
                if err:
                    raise err[0]
                return
            yield item[0]
    finally:
        ch.stop()
        th.join(timeout=5.0)
        if th.is_alive():
            logging.getLogger(__name__).warning(
                "prefetch worker did not exit within 5 s of the consumer "
                "stopping; the upstream source appears blocked")
