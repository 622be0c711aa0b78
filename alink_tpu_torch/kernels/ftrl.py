"""The FTRL state kernels: CUDA wrappers and their plain versions.

Counterpart: ``alink_tpu/kernels/ftrl.py``. There three Pallas kernels
serve the sparse FTRL steps: ``gather_rows`` (``_gather_call``),
``scatter_add_rows`` (``_scatter_call``) and ``chained_corr``. Here the
same three functions are CUDA kernels written by hand for Hopper
(``csrc/ftrl_state.cu``), and :func:`gather_pair` is the gather of ``z``
and ``n`` at once, where the JAX package gathers each and stacks them.
:func:`gather_rows`, :func:`gather_pair`, :func:`scatter_add_rows` and
:func:`chained_corr` are the wrappers; the ``*_plain`` functions beside
them are their plain PyTorch versions. A wrapper given CPU
tensors runs the plain version. Given CUDA tensors it launches its
kernel or raises. The JAX package's mode flag, probes and demotion are
not ported: there is nothing to switch between.

**Contracts** (the JAX package's):

* gather — ``state[idx]``, bitwise; the pair form
  ``torch.stack([z[idx], n[idx]], -1)``, bitwise.
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
from typing import Callable, Dict, Optional

import torch

from . import _build

__all__ = ["gather_rows", "gather_pair", "scatter_add_rows", "chained_corr",
           "gather_rows_plain", "gather_pair_plain", "scatter_add_rows_plain",
           "chained_corr_plain", "launch_counts", "reset_launch_counts"]

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------

def gather_rows_plain(state: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``state[idx]`` for ``state`` (S,) or (S, C) and ``idx`` (M,)."""
    return state.index_select(0, idx)


def gather_pair_plain(z: torch.Tensor, n: torch.Tensor,
                      idx: torch.Tensor) -> torch.Tensor:
    """``torch.stack([z[idx], n[idx]], -1)`` for ``z``, ``n`` (S,) and
    ``idx`` (M,): (M, 2). A slot outside ``[0, S)`` raises
    ``IndexError``."""
    return torch.stack([z.index_select(0, idx), n.index_select(0, idx)], -1)


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

# launch counts: kept without a lock, since an increment of a dict entry
# does not give up the interpreter lock halfway
_counts: Dict[str, int] = {"ftrl_gather": 0, "ftrl_gather_pair": 0,
                           "ftrl_scatter_add": 0, "ftrl_chained_corr": 0}
_lib_lock = threading.Lock()
_fns: Optional[Dict[str, Callable[..., int]]] = None
# the C functions' arguments: i an int, p a pointer (the stream last)
_SIGNATURES = {"alink_ftrl_gather": "ipppiiip",
               "alink_ftrl_gather_pair": "ippppiip",
               "alink_ftrl_scatter_add": "ipppiiip",
               "alink_ftrl_chained_corr": "ipppiiip"}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return dict(_counts)


def reset_launch_counts() -> None:
    for k in _counts:
        _counts[k] = 0


def _functions() -> Dict[str, Callable[..., int]]:
    """The built ``ftrl_state`` library's C functions, their signatures
    declared, resolved once (the error string under ``"error_string"``)."""
    global _fns
    if _fns is not None:
        return _fns
    with _lib_lock:
        if _fns is None:
            from ._build import load_library
            lib = load_library("ftrl_state")
            p, i = ctypes.c_void_p, ctypes.c_int
            fns = {}
            for name, kinds in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = [p if k == "p" else i for k in kinds]
                fn.restype = i
                fns[name] = fn
            err = lib.alink_ftrl_error_string
            err.argtypes = [i]
            err.restype = ctypes.c_char_p
            fns["error_string"] = err
            _fns = fns
        return _fns


def _check(name: str, *tensors: torch.Tensor) -> int:
    """Validate what a kernel reads and writes; returns its dtype code."""
    first = tensors[0]
    if not first.is_cuda:
        raise ValueError(f"{name}: tensors on {first.device}; the kernel "
                         f"takes CUDA tensors and the plain version CPU ones")
    index = first.get_device()
    for t in tensors:
        if t.get_device() != index or not t.is_contiguous():
            raise ValueError(f"{name}: every tensor must be contiguous and "
                             f"on {first.device}, got {t.device}")
        if t.numel() >= 2 ** 31:
            raise ValueError(f"{name}: {tuple(t.shape)} exceeds the "
                             f"kernel's int sizes")
    code = _DTYPE_CODES.get(first.dtype)
    if code is None:
        raise ValueError(f"{name}: state dtype {first.dtype}; the "
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


def _launch(name: str, fn_name: str, index: int, *args: int,
            limits: str = "") -> None:
    """Launch the library's ``fn_name`` on device ``index``'s current
    stream with ``args`` (the tensors as their device pointers); count it
    or raise, naming the C function's ``limits`` in the error. The
    tensors are the caller's: PyTorch's allocator reuses their memory
    only for later work on the same stream, after the kernel."""
    fns = _fns or _functions()
    rc = _build.call(fns[fn_name], index, *args)
    if rc != 0:
        msg = fns["error_string"](rc).decode()
        raise RuntimeError(f"{name}: kernel launch failed: CUDA error "
                           f"{rc} ({msg}){limits}")
    _counts[name] += 1


def _gather_code(name: str, idx: torch.Tensor, st: torch.Tensor,
                 other: Optional[torch.Tensor] = None) -> int:
    """The checks of a gather launch, a few attribute reads: ``st`` (and
    ``other``, of its dtype and shape) and ``idx`` contiguous on one CUDA
    device, ``st`` float32 or float64, ``idx`` (M,) int32. Returns the
    dtype code."""
    index = st.get_device()
    code = _DTYPE_CODES.get(st.dtype)
    if (code is None or not st.is_cuda or not st.is_contiguous()
            or idx.dtype is not torch.int32 or idx.dim() != 1
            or idx.get_device() != index or not idx.is_contiguous()
            or st.numel() >= 2 ** 31
            or (other is not None and (
                other.get_device() != index or other.dtype is not st.dtype
                or other.shape != st.shape or not other.is_contiguous()))):
        states = [st] + ([other] if other is not None else [])
        raise ValueError(
            f"{name}: want contiguous CUDA states of one dtype (float32 or "
            f"float64) and shape, and (M,) int32 slots on their device; got "
            f"states {[(t.device, t.dtype, tuple(t.shape)) for t in states]}"
            f", slots {idx.device} {idx.dtype} {tuple(idx.shape)}")
    return code


def gather_rows(state: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``state[idx]``: the touched slots of the FTRL state. ``state``
    (S,) or (S, C), C in (1, 2); ``idx`` (M,) int32 in ``[0, S)``.
    Replaces ``alink_tpu/kernels/ftrl.py::_gather_call``."""
    if not state.is_cuda and state.device.type == "cpu":
        return gather_rows_plain(state, idx)
    code = _gather_code("gather_rows", idx, state)
    M = idx.shape[0]
    if state.dim() == 1:
        C, out = 1, state.new_empty(M)
    elif state.dim() == 2 and state.shape[1] in (1, 2):
        C = state.shape[1]
        out = state.new_empty((M, C))
    else:
        raise ValueError(f"gather_rows: state {tuple(state.shape)}; want "
                         f"(S,) or (S, C) with C in (1, 2)")
    if M:
        _launch("ftrl_gather", "alink_ftrl_gather", state.get_device(), code,
                state.data_ptr(), idx.data_ptr(), out.data_ptr(), M,
                state.shape[0], C)
    return out


def gather_pair(z: torch.Tensor, n: torch.Tensor,
                idx: torch.Tensor) -> torch.Tensor:
    """``torch.stack([z[idx], n[idx]], -1)``: the touched slots of both
    FTRL states in one launch. ``z`` and ``n`` (S,) of one dtype, ``idx``
    (M,) int32 in ``[0, S)``; returns (M, 2). The same gather as
    :func:`gather_rows` on ``z`` and ``n`` stacked, without the stack."""
    if not z.is_cuda and z.device.type == "cpu":
        return gather_pair_plain(z, n, idx)
    code = _gather_code("gather_pair", idx, z, n)
    if z.dim() != 1:
        raise ValueError(f"gather_pair: want z and n (S,), got "
                         f"{tuple(z.shape)}")
    M = idx.shape[0]
    out = z.new_empty((M, 2))
    if M:
        _launch("ftrl_gather_pair", "alink_ftrl_gather_pair", z.get_device(),
                code, z.data_ptr(), n.data_ptr(), idx.data_ptr(),
                out.data_ptr(), M, z.shape[0])
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
        _launch("ftrl_scatter_add", "alink_ftrl_scatter_add",
                state.get_device(), code, state.data_ptr(), idx.data_ptr(),
                upd.data_ptr(), M, state.shape[0], C, limits=f"; {M} updates: the one-block kernel takes at most "
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
    _launch("ftrl_chained_corr", "alink_ftrl_chained_corr", D.get_device(),
            code, Mk.data_ptr(), D.data_ptr(), out.data_ptr(), k, w, C)
    return out
