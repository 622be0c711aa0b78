"""The level histogram of tree growing: CUDA wrapper and plain version.

Counterpart: ``alink_tpu/operator/common/tree/hist.py::_pallas_level_hist``
(the Pallas kernel) and ``level_hist(..., use_onehot=False)`` (the JAX
package's CPU default, an XLA scatter-add). Here the function is a CUDA
kernel written by hand for Hopper (``csrc/tree_hist.cu``): a stable
counting sort of each feature's rows by (node, bin), then one ordered
walk per slot, four passes that one call launches into scratch the
wrapper allocates (sized by :func:`_hist_plan`). :func:`level_hist` is
the wrapper and :func:`level_hist_plain` its plain PyTorch version.
Given CPU tensors the wrapper runs the plain version; given CUDA
tensors it launches the kernel or raises.

**Contract.** ``out[node, f, bin, :]`` is the sum of ``stats[i, :]`` over
the rows ``i`` with ``node_id[i] == node`` and ``binned[i, f] == bin``,
each (node, f, bin, stat) slot adding its rows in ascending row order
from ``+0.0``, one rounded float32 add each. That is the JAX package's
CPU default bit for bit. The kernel and the plain version compute it
bitwise alike, with no float atomics, so two runs on the card give the
same bits. Against the Pallas kernel (a one-hot matrix product whose
summation order is the MXU's) the result agrees within the recursive
summation bound. A bin outside ``[0, n_bins)`` or a node outside
``[0, n_nodes)`` raises ``IndexError`` on the CPU and fails the kernel's
device-side assert on the card (reported as a ``RuntimeError`` at the
stream's next synchronize).

**The plain version** keeps the order without a loop over rows: it
sorts the (row, feature) pairs by slot, stably, so each slot's rows sit
in a segment in ascending row order, and round ``r`` adds the ``r``-th
row of every segment that has one. It takes as many rounds as the
fullest slot has rows, and reads their number on the host once.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

__all__ = ["level_hist", "level_hist_plain", "launch_counts",
           "reset_launch_counts"]


def _check_ids(binned: torch.Tensor, node_id: torch.Tensor, n_nodes: int,
               n_bins: int) -> None:
    if binned.numel() and (int(binned.min()) < 0
                           or int(binned.max()) >= n_bins):
        raise IndexError(f"level_hist: bins outside [0, {n_bins})")
    if node_id.numel() and (int(node_id.min()) < 0
                            or int(node_id.max()) >= n_nodes):
        raise IndexError(f"level_hist: nodes outside [0, {n_nodes})")


def level_hist_plain(binned: torch.Tensor, stats: torch.Tensor,
                     node_id: torch.Tensor, n_nodes: int,
                     n_bins: int) -> torch.Tensor:
    """``(n_nodes, F, n_bins, m)`` per-slot sums of ``stats`` (n, m),
    each slot's rows added in ascending row order from ``+0.0``.
    ``binned`` (n, F) int32 in any layout, ``node_id`` (n,) int32."""
    n, F = binned.shape
    m = stats.shape[1]
    dev = stats.device
    _check_ids(binned, node_id, n_nodes, n_bins)
    out = torch.zeros((n_nodes * F * n_bins, m), dtype=stats.dtype,
                      device=dev)
    if n == 0:
        return out.view(n_nodes, F, n_bins, m)
    feat = torch.arange(F, dtype=torch.int64, device=dev)
    slot = ((node_id.long()[:, None] * F + feat[None, :]) * n_bins
            + binned.long()).reshape(-1)
    # pair p = i * F + f: a stable sort keeps each slot's rows ascending
    order = torch.sort(slot, stable=True).indices
    slots, counts = torch.unique_consecutive(slot[order], return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    by_len = torch.sort(counts, descending=True, stable=True).indices
    starts = starts[by_len]
    vals = stats.index_select(0, order // F)          # pairs in slot order
    lens = np.sort(counts.cpu().numpy())              # ascending, on the host
    acc = torch.zeros((slots.numel(), m), dtype=stats.dtype, device=dev)
    for r in range(int(lens[-1])):
        k = lens.size - int(np.searchsorted(lens, r, side="right"))
        acc[:k] += vals.index_select(0, starts[:k] + r)
    out[slots[by_len]] = acc
    return out.view(n_nodes, F, n_bins, m)


# ---------------------------------------------------------------------------
# the kernel wrapper
# ---------------------------------------------------------------------------

_MIN_TILE_ROWS = 1024      # csrc/tree_hist.cu: kMinTileRows
_MAX_TILES = 32            # csrc/tree_hist.cu: kMaxTiles
_MAX_KEYS = 1 << 23        # n_nodes * n_bins the plan takes
_MAX_F = 65535             # the passes' grid.y


class HistPlan(NamedTuple):
    """The sizes of one ``level_hist`` launch (``csrc/tree_hist.cu``)."""
    tile_rows: int          # rows a count/place warp takes, a power of two
    tiles: int              # row tiles per feature
    count_elems: int        # int32 counts table, F * Q * tiles
    perm_elems: int         # int32 sorted row ids, F * n
    scratch_bytes: int


def _hist_plan(n: int, F: int, n_nodes: int, n_bins: int) -> HistPlan:
    """Tile rows and scratch of the kernel for an (n, F) level of
    ``n_nodes * n_bins`` keys. The tile takes at least 1024 rows, at
    least twice the keys and at least a 32nd of the rows, so the counts
    table is at most half the keys' bytes plus one int per (feature,
    key). Raises ``ValueError`` past the kernel's limits."""
    Q = n_nodes * n_bins
    if n < 0 or F <= 0 or n_nodes <= 0 or n_bins <= 0:
        raise ValueError(f"level_hist: bad shape n={n} F={F} "
                         f"{n_nodes} x {n_bins} buckets")
    if n >= 2 ** 31 or F > _MAX_F or Q > _MAX_KEYS:
        raise ValueError(f"level_hist: n={n}, F={F}, {n_nodes} x {n_bins} "
                         f"buckets: the kernel takes n < 2^31, F <= "
                         f"{_MAX_F} and at most {_MAX_KEYS} buckets")
    least = max(_MIN_TILE_ROWS, 2 * Q, -(-n // _MAX_TILES))
    tile_rows = 1 << (least - 1).bit_length()
    tiles = max(1, -(-n // tile_rows))
    count_elems = F * Q * tiles
    perm_elems = F * n
    return HistPlan(tile_rows, tiles, count_elems, perm_elems,
                    4 * (count_elems + perm_elems))


_counts_lock = threading.Lock()
_counts: Dict[str, int] = {"tree_hist": 0}
_lib_lock = threading.Lock()
_lib_handle: Optional[ctypes.CDLL] = None


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last reset."""
    with _counts_lock:
        return dict(_counts)


def reset_launch_counts() -> None:
    with _counts_lock:
        for k in _counts:
            _counts[k] = 0


def _lib() -> ctypes.CDLL:
    """The built ``tree_hist`` library, its C signatures declared."""
    global _lib_handle
    if _lib_handle is not None:
        return _lib_handle
    with _lib_lock:
        if _lib_handle is None:
            from ._build import load_library
            lib = load_library("tree_hist")
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.alink_tree_hist.argtypes = [p, ll, ll, p, i, p, p, i, i, i,
                                            i, i, i, p, p, p]
            lib.alink_tree_hist.restype = i
            lib.alink_tree_hist_error_string.argtypes = [i]
            lib.alink_tree_hist_error_string.restype = ctypes.c_char_p
            _lib_handle = lib
        return _lib_handle


def level_hist(binned: torch.Tensor, stats: torch.Tensor,
               node_id: torch.Tensor, n_nodes: int,
               n_bins: int) -> torch.Tensor:
    """The level histogram ``(n_nodes, F, n_bins, m)`` float32 of
    ``stats`` (n, m) float32 by ``node_id`` (n,) int32 and ``binned``
    (n, F) int32. ``binned`` may be any strided view with non-negative
    strides: a column-major copy's transpose reads fastest, and a
    stride-0 zero column serves the leaf histogram (``n_bins = 1``).
    Replaces ``alink_tpu/operator/common/tree/hist.py::_pallas_level_hist``."""
    if stats.device.type == "cpu":
        return level_hist_plain(binned, stats, node_id, n_nodes, n_bins)
    dev = stats.device
    if dev.type != "cuda":
        raise ValueError(f"level_hist: tensors on {dev}; the kernel takes "
                         f"CUDA tensors and the plain version CPU ones")
    n, m = stats.shape
    if binned.dim() != 2 or binned.shape[0] != n:
        raise ValueError(f"level_hist: binned {tuple(binned.shape)} vs "
                         f"stats {tuple(stats.shape)}")
    F = binned.shape[1]
    for name, t, dtype in (("binned", binned, torch.int32),
                           ("stats", stats, torch.float32),
                           ("node_id", node_id, torch.int32)):
        if t.device != dev:
            raise ValueError(f"level_hist: {name} on {t.device}, stats on "
                             f"{dev}")
        if t.dtype != dtype:
            raise ValueError(f"level_hist: {name} is {t.dtype}; the kernel "
                             f"takes {dtype}")
    if not stats.is_contiguous() or not node_id.is_contiguous() \
            or node_id.shape != (n,):
        raise ValueError("level_hist: stats (n, m) and node_id (n,) must be "
                         "contiguous")
    sr, sf = binned.stride()
    if sr < 0 or sf < 0 or m > 4 * 65535:
        raise ValueError(f"level_hist: binned strides {(sr, sf)} or {m} "
                         f"stats outside what the kernel takes")
    plan = _hist_plan(n, F, n_nodes, n_bins)
    lib = _lib()
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return level_hist(binned, stats, node_id, n_nodes, n_bins)
    out = torch.empty((n_nodes, F, n_bins, m), dtype=torch.float32,
                      device=dev)
    # one int32 scratch: the counts table, then the sorted row ids
    scratch = torch.empty(plan.count_elems + plan.perm_elems,
                          dtype=torch.int32, device=dev)
    base = scratch.data_ptr()
    rc = lib.alink_tree_hist(binned.data_ptr(), sr, sf, stats.data_ptr(), m,
                             node_id.data_ptr(), out.data_ptr(), n, F,
                             n_nodes, n_bins, plan.tile_rows, plan.tiles,
                             base, base + 4 * plan.count_elems,
                             torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = lib.alink_tree_hist_error_string(rc).decode()
        raise RuntimeError(f"tree_hist: kernel launch failed: CUDA error "
                           f"{rc} ({msg}); plan {plan}")
    with _counts_lock:
        _counts["tree_hist"] += 1
    return out
