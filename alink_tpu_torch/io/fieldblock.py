"""Field-blocked LibSVM files to the card.

No module of ``alink_tpu`` holds this loader: it is the port's form of
the load leg of ``bench.py::bench_logreg_from_disk``. A LibSVM file of
one-hot field-major rows (``label j:1 ...``, one id a field, field by
field) is read in newline-aligned byte-range shards on the ordered
:func:`~alink_tpu_torch.operator.stream.prefetch.prefetch_map` pool,
each shard parsed by the native ``parse_libsvm_fb16`` straight into
int16 field-local ids and float32 labels. The shards join in groups into
pinned host buffers, each copied to the card with ``non_blocking=True``
while later shards still read and parse (a non-blocking copy from
pageable memory would be synchronous), then one ``torch.cat`` and the
int16 -> int32 widening run on the card, so 2 bytes an id cross the bus.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..common.device import resolve_device
from ..native import parse_libsvm_fb16
from .csv import _load_line_bytes


def load_fieldblock_libsvm(path: str, n_fields: int, field_size: int, *,
                           shards: int = 64, groups: int = 16,
                           workers: Optional[int] = None, device=None,
                           start_index: int = 1
                           ) -> Tuple[torch.Tensor, torch.Tensor, dict]:
    """``(fb, labels, stats)`` of the field-blocked LibSVM file ``path``
    on ``device`` (the card unless given): ``fb`` int32 ``(rows,
    n_fields)`` field-local ids, ``labels`` float32, in the file's row
    order.

    ``shards`` byte ranges are read and parsed on ``workers`` threads
    (default ``min(8, cores)``) and sent in ``groups`` copies. A shard
    whose rows are not one-hot and field-major, or a ``field_size`` past
    int16, raises ``ValueError``. ``stats`` holds ``read_s`` and
    ``parse_s`` (summed over the shards), ``copy_s`` (the groups' joins
    into pinned buffers and the copies' issue), ``rp_wall_s`` (the
    loader's wall clock, copies done), and the ``shards``, ``groups``
    and ``workers`` it ran with."""
    from ..operator.stream.prefetch import prefetch_map
    dev = resolve_device(device)
    workers = min(8, os.cpu_count() or 1) if workers is None \
        else max(1, int(workers))
    pin = dev.type == "cuda"

    def load_shard(i):
        t0 = time.perf_counter()
        b = _load_line_bytes(path, False, (i, shards))
        t1 = time.perf_counter()
        got = parse_libsvm_fb16(b, n_fields, field_size, start_index)
        if got is None:
            raise ValueError(
                f"{path}: shard {i} of {shards} is not one-hot field-major "
                f"LibSVM over {n_fields} fields of {field_size}")
        return got, t1 - t0, time.perf_counter() - t1

    per_group = -(-shards // groups)
    st = {"read_s": 0.0, "parse_s": 0.0, "copy_s": 0.0}
    hosts, fb_parts, lab_parts, pend = [], [], [], []

    def flush():
        t0 = time.perf_counter()
        rows = sum(len(lab) for lab, _ in pend)
        fb_h = torch.empty((rows, n_fields), dtype=torch.int16,
                           pin_memory=pin)
        lab_h = torch.empty(rows, dtype=torch.float32, pin_memory=pin)
        np.concatenate([fb for _, fb in pend], out=fb_h.numpy())
        np.concatenate([lab for lab, _ in pend], out=lab_h.numpy())
        hosts.append((fb_h, lab_h))      # each outlives its copy
        fb_parts.append(fb_h.to(dev, non_blocking=True))
        lab_parts.append(lab_h.to(dev, non_blocking=True))
        pend.clear()
        st["copy_s"] += time.perf_counter() - t0

    t0 = time.perf_counter()
    for part, r_s, p_s in prefetch_map(iter(range(shards)), load_shard,
                                       workers=workers):
        st["read_s"] += r_s
        st["parse_s"] += p_s
        pend.append(part)
        if len(pend) >= per_group:
            flush()
    if pend:
        flush()
    fb = torch.cat(fb_parts).to(torch.int32)
    labels = torch.cat(lab_parts)
    if pin:
        torch.cuda.synchronize(dev)
    st.update(rp_wall_s=time.perf_counter() - t0, shards=shards,
              groups=len(hosts), workers=workers)
    return fb, labels, st
