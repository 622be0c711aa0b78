"""The FTRL state kernels: CUDA wrappers and their plain versions.

Counterpart: ``alink_tpu/kernels/ftrl.py``. There three Pallas kernels
serve the sparse FTRL steps: ``gather_rows`` (``_gather_call``),
``scatter_add_rows`` (``_scatter_call``) and ``chained_corr``. Here the
same three functions are CUDA kernels written by hand for Hopper
(``csrc/ftrl_state.cu``). :func:`gather_rows`, :func:`scatter_add_rows`
and :func:`chained_corr` are the wrappers; the ``*_plain`` functions
beside them are their plain PyTorch versions. A wrapper given CPU
tensors runs the plain version. Given CUDA tensors it launches its
kernel or raises. The JAX package's mode flag, probes and demotion are
not ported: there is nothing to switch between.

**Contracts** (the JAX package's):

* gather — ``state[idx]``, bitwise.
* scatter-add — ``state.at[idx].add(upd)``: duplicate slots accumulate
  in update order, one rounded add each; a slot that no update names
  keeps its bits (a stored ``-0.0`` survives). The port updates the
  state IN PLACE and returns it: the JAX package's functional update
  would copy the whole 2^20-slot state once per chunk.
* chained — ``sum_{j<k} Mk[j] @ D[j]``: one chain per output in the
  order ``j`` then ``b``, every product rounded on its own, in the
  state dtype (no TF32). Against the JAX package's einsum this is an
  association-only difference (rtol 1e-12 in float64); against the
  plain version below it is bitwise.
* slots — an index outside ``[0, S)`` raises: ``IndexError`` at once
  on the CPU; on the card a device-side assert, which the stream
  reports as a ``RuntimeError`` at its next synchronize (as PyTorch's
  own CUDA indexing does).

The plain versions are deterministic on any device and vectorised: an
in-order sum only ever changes at its non-zero terms (an accumulator
that starts at ``+0.0`` never becomes ``-0.0`` under round to nearest,
so adding a ``+-0.0`` term is a no-op), so each one adds the r-th
non-zero term of every output (or the r-th update of every slot) in
round r, which keeps the order and needs as many rounds as the longest
chain has such terms.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional

import torch

__all__ = ["gather_rows", "scatter_add_rows", "chained_corr",
           "gather_rows_plain", "scatter_add_rows_plain",
           "chained_corr_plain", "launch_counts", "reset_launch_counts"]

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------

def gather_rows_plain(state: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``state[idx]`` for ``state`` (S,) or (S, C) and ``idx`` (M,)."""
    return state.index_select(0, idx)


def scatter_add_rows_plain(state: torch.Tensor, idx: torch.Tensor,
                           upd: torch.Tensor) -> torch.Tensor:
    """``state[idx[m]] += upd[m]`` for m in order, in place; returns
    ``state``. Round r adds every slot's r-th update: the slots of one
    round are distinct, so each round is one plain indexed add. A slot
    outside ``[0, S)`` raises ``IndexError`` (negative ones too: they
    would wrap)."""
    ix = idx.long()
    if ix.numel() and (int(ix.min()) < 0 or int(ix.max()) >= state.shape[0]):
        raise IndexError(f"scatter_add_rows: slots outside [0, "
                         f"{state.shape[0]})")
    order = torch.sort(ix, stable=True).indices
    sorted_ix = ix[order]
    pos = torch.arange(ix.numel(), device=ix.device)
    new = torch.ones_like(sorted_ix, dtype=torch.bool)
    new[1:] = sorted_ix[1:] != sorted_ix[:-1]
    first = torch.cummax(torch.where(new, pos, torch.zeros_like(pos)),
                         0).values
    rank = pos - first                        # occurrence number, in order
    for r in range(int(rank.max()) + 1 if ix.numel() else 0):
        sel = order[rank == r]
        slots = ix[sel]
        state[slots] = state[slots] + upd[sel]
    return state


def chained_corr_plain(Mk: torch.Tensor, D: torch.Tensor,
                       k: int) -> torch.Tensor:
    """``sum_{j<k} Mk[j] @ D[j]`` as the kernel sums it: for each output
    ``(a, c)`` the products ``Mk[j, a, b] * D[j, b, c]`` added in the
    order ``(j, b)`` from ``+0.0``. ``Mk`` (K, w, w), ``D`` (K, w, C);
    returns (w, C)."""
    K, w, _ = Mk.shape
    C = D.shape[2]
    acc = torch.zeros((w, C), dtype=D.dtype, device=D.device)
    if k == 0:
        return acc
    # terms[a, c, j*w + b], each product rounded on its own
    terms = (Mk[:k, :, :, None] * D[:k, None, :, :]).permute(1, 3, 0, 2) \
        .reshape(w, C, k * w)
    live = terms != 0                          # NaN counts as live
    rank = torch.cumsum(live, -1) - 1
    zero = torch.zeros((), dtype=D.dtype, device=D.device)
    for r in range(int(live.sum(-1).max())):
        # exactly one term per output is picked: the sum is that term
        acc = acc + torch.where(live & (rank == r), terms, zero).sum(-1)
    return acc


# ---------------------------------------------------------------------------
# the kernel wrappers
# ---------------------------------------------------------------------------

_counts_lock = threading.Lock()
_counts: Dict[str, int] = {"ftrl_gather": 0, "ftrl_scatter_add": 0,
                           "ftrl_chained_corr": 0}
_lib_lock = threading.Lock()
_lib_handle: Optional[ctypes.CDLL] = None


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    with _counts_lock:
        return dict(_counts)


def reset_launch_counts() -> None:
    with _counts_lock:
        for k in _counts:
            _counts[k] = 0


def _count(name: str) -> None:
    with _counts_lock:
        _counts[name] += 1


def _lib() -> ctypes.CDLL:
    """The built ``ftrl_state`` library, its C signatures declared."""
    global _lib_handle
    with _lib_lock:
        if _lib_handle is None:
            from ._build import load_library
            lib = load_library("ftrl_state")
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.alink_ftrl_gather.argtypes = [i, p, p, p, i, i, i, p]
            lib.alink_ftrl_scatter_add.argtypes = [i, p, p, p, i, i, i, p]
            lib.alink_ftrl_chained_corr.argtypes = [i, p, p, p, i, i, i, p]
            for fn in (lib.alink_ftrl_gather, lib.alink_ftrl_scatter_add,
                       lib.alink_ftrl_chained_corr):
                fn.restype = i
            lib.alink_ftrl_error_string.argtypes = [i]
            lib.alink_ftrl_error_string.restype = ctypes.c_char_p
            _lib_handle = lib
        return _lib_handle


def _check(name: str, *tensors: torch.Tensor) -> int:
    """Validate what a kernel reads and writes; returns its dtype code."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors on {dev}; the kernel takes "
                         f"CUDA tensors and the plain version CPU ones")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: every tensor must be contiguous")
        if t.numel() >= 2 ** 31:
            raise ValueError(f"{name}: {tuple(t.shape)} exceeds the "
                             f"kernel's int sizes")
    code = _DTYPE_CODES.get(tensors[0].dtype)
    if code is None:
        raise ValueError(f"{name}: state dtype {tensors[0].dtype}; the "
                         f"kernel takes float32 or float64")
    return code


def _check_state(name: str, state: torch.Tensor, idx: torch.Tensor) -> int:
    if state.dim() not in (1, 2) or (state.dim() == 2
                                     and state.shape[1] not in (1, 2)):
        raise ValueError(f"{name}: state {tuple(state.shape)}; want (S,) "
                         f"or (S, C) with C in (1, 2)")
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise ValueError(f"{name}: want (M,) int32 slot indices, got "
                         f"{idx.dtype} {tuple(idx.shape)}")
    return 1 if state.dim() == 1 else state.shape[1]


def _launch(name: str, fn_name: str, *args, device: torch.device,
            limits: str = "") -> None:
    """Launch the library's ``fn_name`` on ``device``'s current stream,
    tensors passed as their device pointers; count it or raise, naming
    the C function's ``limits`` in the error. The tensors are the
    caller's: PyTorch's allocator reuses their memory only for later
    work on the same stream, after the kernel."""
    lib = _lib()
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
            for a in args]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn_name)(*ptrs, stream)
    if rc != 0:
        msg = _lib().alink_ftrl_error_string(rc).decode()
        raise RuntimeError(f"{name}: kernel launch failed: CUDA error "
                           f"{rc} ({msg}){limits}")
    _count(name)


def gather_rows(state: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``state[idx]``: the touched slots of the FTRL state. ``state``
    (S,) or (S, C), C in (1, 2); ``idx`` (M,) int32 in ``[0, S)``.
    Replaces ``alink_tpu/kernels/ftrl.py::_gather_call``."""
    if state.device.type == "cpu":
        return gather_rows_plain(state, idx)
    C = _check_state("gather_rows", state, idx)
    code = _check("gather_rows", state, idx)
    M = idx.shape[0]
    out = torch.empty((M,) + tuple(state.shape[1:]), dtype=state.dtype,
                      device=state.device)
    if M:
        _launch("ftrl_gather", "alink_ftrl_gather", code, state, idx, out,
                M, state.shape[0], C, device=state.device)
    return out


def scatter_add_rows(state: torch.Tensor, idx: torch.Tensor,
                     upd: torch.Tensor) -> torch.Tensor:
    """``state[idx[m]] += upd[m]`` for m in order, IN PLACE; returns
    ``state``. Duplicate slots add in update order; untouched slots are
    never written. ``state`` (S,) or (S, C); ``upd`` (M,) or (M, C).
    Replaces ``alink_tpu/kernels/ftrl.py::_scatter_call``."""
    if state.device.type == "cpu":
        return scatter_add_rows_plain(state, idx, upd)
    C = _check_state("scatter_add_rows", state, idx)
    code = _check("scatter_add_rows", state, idx, upd)
    M = idx.shape[0]
    if upd.dtype != state.dtype or upd.shape != (M,) + tuple(state.shape[1:]):
        raise ValueError(f"scatter_add_rows: updates {upd.dtype} "
                         f"{tuple(upd.shape)} vs state {state.dtype} "
                         f"{tuple(state.shape)} and {M} indices")
    if M:
        _launch("ftrl_scatter_add", "alink_ftrl_scatter_add", code, state,
                idx, upd, M, state.shape[0], C, device=state.device,
                limits=f"; {M} updates: the one-block kernel takes at most "
                       f"kScatterMaxM of csrc/ftrl_state.cu")
    return state


def chained_corr(Mk: torch.Tensor, D: torch.Tensor, k: int) -> torch.Tensor:
    """``sum_{j<k} Mk[j] @ D[j]``, the chained step's correction of
    sample ``k`` from the deltas of the earlier samples of its chunk.
    ``Mk`` (K, w, w) 0/1 in the state dtype, ``D`` (K, w, C); returns
    (w, C). ``k = 0`` gives zeros and launches nothing. Replaces
    ``alink_tpu/kernels/ftrl.py::chained_corr``."""
    if D.device.type == "cpu":
        return chained_corr_plain(Mk, D, k)
    code = _check("chained_corr", D, Mk)
    K, w, C = D.shape
    if Mk.dtype != D.dtype or Mk.shape != (K, w, w) or not 0 <= k <= K:
        raise ValueError(f"chained_corr: Mk {Mk.dtype} {tuple(Mk.shape)}, "
                         f"D {D.dtype} {tuple(D.shape)}, k {k}")
    if not k:
        return torch.zeros((w, C), dtype=D.dtype, device=D.device)
    out = torch.empty((w, C), dtype=D.dtype, device=D.device)
    _launch("ftrl_chained_corr", "alink_ftrl_chained_corr", code, Mk, D, out,
            k, w, C, device=D.device)
    return out
