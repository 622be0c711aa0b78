"""Shared protocol for columnar MTable column classes.

PyTorch port: a copy of ``alink_tpu/common/columnar.py``
(numpy only; the port keeps its own copy so that it never imports the
JAX package).

A columnar column stores n logical cells as dense arrays and duck-types
the 1-D object-ndarray surface MTable uses (``shape``/``dtype``/
``len``/int-vs-fancy indexing/iteration/``copy``), materializing a
per-row Python value only when a consumer actually asks for one.
Subclasses implement ``_render_row`` (one cell), ``_subset`` (row
selection -> same column type), ``__len__``, ``copy`` and optionally
``concat_same`` (same-typed concatenation for MTable.concat_rows).
"""

from __future__ import annotations

import numpy as np


class ColumnarColumn:
    __mtable_column__ = True
    dtype = np.dtype(object)

    def _render_row(self, i: int):  # pragma: no cover - interface
        raise NotImplementedError

    def _subset(self, sel):  # pragma: no cover - interface
        raise NotImplementedError

    def __len__(self):  # pragma: no cover - interface
        raise NotImplementedError

    @property
    def shape(self):
        return (len(self),)

    def __getitem__(self, i):
        if isinstance(i, (int, np.integer)):
            return self._render_row(int(i))
        return self._subset(i)

    def __iter__(self):
        for i in range(len(self)):
            yield self._render_row(i)

    def concat_same(self, other):
        return None

    def materialize(self) -> np.ndarray:
        out = np.empty(len(self), object)
        out[:] = list(self)
        return out
