"""Event-time merging of timed streams.

Counterpart: ``alink_tpu/operator/stream/core.py``. Only
:func:`merge_timed` is ported, for ``FtrlPredictStreamOp``'s model and
data streams; the per-batch transform base waits for the stream
operators that need it.
"""

from __future__ import annotations

import heapq
from typing import Iterable, Iterator, Tuple

from ...common.mtable import MTable

TimedBatch = Tuple[float, MTable]


def merge_timed(*streams: Iterable[TimedBatch]) -> Iterator[Tuple[float, int, MTable]]:
    """Merge timed streams in event-time order; yields (time, stream_idx, table).

    Ties break by stream index (earlier input wins), matching the reference's
    model-stream-then-data convention for co-flat-map operators.
    """
    def tag(i, s):
        for t, mt in s:
            yield (t, i, mt)

    return heapq.merge(*[tag(i, s) for i, s in enumerate(streams)],
                       key=lambda x: (x[0], x[1]))
