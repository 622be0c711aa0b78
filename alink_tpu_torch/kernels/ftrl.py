"""The FTRL state kernels: CUDA wrappers and their plain versions.

Counterpart: ``alink_tpu/kernels/ftrl.py``. There three Pallas kernels
serve the sparse FTRL steps: ``gather_rows`` (``_gather_call``),
``scatter_add_rows`` (``_scatter_call``) and ``chained_corr``. Here the
gather and the scatter-add are CUDA kernels written by hand for Hopper
(``csrc/ftrl_state.cu``), :func:`gather_pair` is the gather of ``z``
and ``n`` at once, where the JAX package gathers each and stacks them,
and ``chained_corr`` is part of :func:`walk_chunk`: ONE kernel walks a
whole chunk of the strict steps (sample k's corrections from the
earlier samples, its weights, margin, gradient and deltas, for k in
order), in the chained step's association or the per-sample step's.
:func:`gather_rows`, :func:`gather_pair`, :func:`scatter_add_rows` and
:func:`walk_chunk` are the wrappers; the ``*_plain`` functions beside
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
* walk — the per-sample loop of the strict steps over one chunk, with
  the corrections in the chained association (above) or the per-sample
  one (for each earlier sample j in order, the in-order sum from
  ``+0.0`` of its deltas at sample k's slot, added to the running
  value), and the margin as a pairwise tree (:func:`tree_sum`).
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
import functools
import threading
from typing import Callable, Dict, Optional

import numpy as np
import torch

from . import _build

__all__ = ["gather_rows", "gather_pair", "scatter_add_rows", "walk_chunk",
           "gather_rows_plain", "gather_pair_plain", "scatter_add_rows_plain",
           "chained_corr_plain", "walk_chunk_plain", "ftrl_weights",
           "tree_sum", "launch_counts", "reset_launch_counts"]

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}
# csrc/ftrl_state.cu's kWalkMaxP: K * w of one chunk, as many positions as
# the scatter-add of the chunk's deltas takes (kScatterMaxM)
WALK_MAX_POSITIONS = 11264


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
    round are distinct, so each round is one plain indexed add (the
    updates grouped by round once, so a round costs its own size). A
    slot outside ``[0, S)`` raises ``IndexError`` (negative ones too:
    they would wrap)."""
    ix = idx.long()
    if not ix.numel():
        return state
    if int(ix.min()) < 0 or int(ix.max()) >= state.shape[0]:
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
    by_round = order[torch.sort(rank, stable=True).indices]
    ends = torch.cumsum(torch.bincount(rank), 0).tolist()
    for a, b in zip([0] + ends[:-1], ends):
        sel = by_round[a:b]
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


def ftrl_weights(z, n, alpha, beta, l1, l2):
    """w from the accumulated (z, n) state — the FTRL-proximal closed form
    (one copy shared by every step and the snapshot path). On the card
    PyTorch divides by the Python float ``alpha`` as a multiply by its
    reciprocal, which the walk kernel does too."""
    decay = (beta + torch.sqrt(n)) / alpha + l2
    w = -(z - torch.sign(z) * l1) / decay
    return torch.where(torch.abs(z) <= l1, 0.0, w)


def sigmoid(margin):
    """The clipped logistic of the steps: ``1.0 / t`` is PyTorch's
    ``t.reciprocal() * 1.0``, which the walk kernel rounds alike."""
    return 1.0 / (1.0 + torch.exp(-torch.clamp(margin, -35.0, 35.0)))


def tree_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum over the last dimension as a pairwise tree: padded with
    ``+0.0`` to the next power of two P, then ``t[..., :h] + t[..., h:]``
    for h = P/2, ..., 1. The walk kernel adds in this order (its lanes'
    butterfly), and the same expression gives the same bits on any
    device, where the order of ``torch.sum`` is the device's."""
    n = t.shape[-1]
    size = 1 << max(0, n - 1).bit_length()
    if size != n:
        t = torch.cat([t, t.new_zeros(t.shape[:-1] + (size - n,))], -1)
    while t.shape[-1] > 1:
        h = t.shape[-1] // 2
        t = t[..., :h] + t[..., h:]
    return t[..., 0]


def _ordered_partials(sel: torch.Tensor, D: torch.Tensor) -> torch.Tensor:
    """``partial[j, a, c]``: the deltas ``D[j, b, c]`` of the ``b`` with
    ``sel[j, a, b]``, added in the order of ``b`` from ``+0.0`` (a
    selection, not a product: a NaN delta elsewhere does not leak).
    ``sel`` (k, w, w) bool, ``D`` (k, w, C); returns (k, w, C)."""
    k, w, C = D.shape
    acc = D.new_zeros((k, w, C))
    if not k:
        return acc
    rank = torch.cumsum(sel, -1) - 1
    for r in range(int(sel.sum(-1).max())):
        pick = (sel & (rank == r))[..., None]
        # exactly one delta per output is picked: the sum is that delta
        acc = acc + torch.where(pick, D[:, None], 0.0).sum(2)
    return acc


def walk_chunk_plain(xi: torch.Tensor, xv: torch.Tensor, yy: torch.Tensor,
                     zn: torch.Tensor, margins: torch.Tensor, row: int,
                     alpha: float, beta: float, l1: float, l2: float,
                     chained: bool) -> torch.Tensor:
    """One chunk of the strict FTRL steps, sample by sample. ``xi`` (K, w)
    slots, ``xv`` (K, w) values, ``yy`` (K,) 0/1 labels, ``zn`` (K * w, 2)
    the chunk's slots of z and n before the chunk (:func:`gather_pair`).
    For k in order: sample k's z and n corrected by the deltas of samples
    j < k at its slots; w (:func:`ftrl_weights`); the margin
    (:func:`tree_sum` of ``x * w``), written to ``margins[row + k]``; the
    gradient and the deltas (g - sigma * w, g^2). Returns the deltas as
    (2, K * w): row 0 for z, row 1 for n, ready for
    :func:`scatter_add_rows`.

    ``chained``: the correction is ``chained_corr_plain`` of the collision
    tensor (the chained step's association, NaN deltas at other slots
    reaching it as 0 * NaN). Else the per-sample step's: for j = 0 ... k-1
    in order, the in-order partial of sample j's deltas at the slot
    (:func:`_ordered_partials`), added to the running value."""
    K, w = xi.shape
    zn = zn.view(K, w, 2)
    same = xi[:, None, :, None] == xi[None, :, None, :]      # (K, K, w, w)
    D = zn.new_zeros((K, w, 2))
    if chained:
        M = same.to(zn.dtype)
    for k in range(K):
        if chained:
            corr = chained_corr_plain(M[k], D, k)
            zk, nk = zn[k, :, 0] + corr[:, 0], zn[k, :, 1] + corr[:, 1]
        else:
            znk = zn[k]
            part = _ordered_partials(same[k, :k], D[:k])
            for j in range(k):
                znk = znk + part[j]
            zk, nk = znk[:, 0], znk[:, 1]
        wk = ftrl_weights(zk, nk, alpha, beta, l1, l2)
        margin = tree_sum(xv[k] * wk)
        g = (sigmoid(margin) - yy[k]) * xv[k]
        gg = g * g
        sigma = (torch.sqrt(nk + gg) - torch.sqrt(nk)) / alpha
        D[k, :, 0] = g - sigma * wk
        D[k, :, 1] = gg
        margins[row + k] = margin
    return D.permute(2, 0, 1).contiguous().view(2, K * w)


# ---------------------------------------------------------------------------
# the kernel wrappers
# ---------------------------------------------------------------------------

# launch counts: kept without a lock, since an increment of a dict entry
# does not give up the interpreter lock halfway
_counts: Dict[str, int] = {"ftrl_gather": 0, "ftrl_gather_pair": 0,
                           "ftrl_scatter_add": 0, "ftrl_walk": 0}
_lib_lock = threading.Lock()
_fns: Optional[Dict[str, Callable[..., int]]] = None
# the C functions' arguments: i an int, d a double, p a pointer (the
# stream last)
_SIGNATURES = {"alink_ftrl_gather": "ipppiiip",
               "alink_ftrl_gather_pair": "ippppiip",
               "alink_ftrl_scatter_add": "ipppiiip",
               "alink_ftrl_walk": "iippppppiiddddpp"}
_CTYPES = {"i": ctypes.c_int, "d": ctypes.c_double, "p": ctypes.c_void_p}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return dict(_counts)


def reset_launch_counts() -> None:
    for k in _counts:
        _counts[k] = 0


def _functions() -> Dict[str, Callable[..., int]]:
    """The built ``ftrl_state`` library's C functions, their signatures
    declared, resolved once (the error string under ``"error_string"``,
    the walk's spill size under ``"walk_spill"``)."""
    global _fns
    if _fns is not None:
        return _fns
    with _lib_lock:
        if _fns is None:
            from ._build import load_library
            lib = load_library("ftrl_state")
            fns = {}
            for name, kinds in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = [_CTYPES[k] for k in kinds]
                fn.restype = ctypes.c_int
                fns[name] = fn
            spill = lib.alink_ftrl_walk_spill
            spill.argtypes = [ctypes.c_int] * 3
            spill.restype = ctypes.c_longlong
            fns["walk_spill"] = spill
            err = lib.alink_ftrl_error_string
            err.argtypes = [ctypes.c_int]
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


@functools.lru_cache(maxsize=64)
def _walk_spill(code: int, K: int, w: int) -> int:
    """The bytes of global memory a walk of K rows of width w needs for
    its chunk: 0 when the chunk fits in shared memory."""
    return int((_fns or _functions())["walk_spill"](code, K, w))


@functools.lru_cache(maxsize=64)
def _reciprocal(alpha: float, dtype: torch.dtype) -> float:
    """``1 / alpha`` rounded in ``dtype``, as PyTorch's CUDA division of a
    tensor by a Python float computes it (then multiplies)."""
    if dtype == torch.float32:
        return float(np.float32(1.0) / np.float32(alpha))
    return 1.0 / float(alpha)


def walk_chunk(xi: torch.Tensor, xv: torch.Tensor, yy: torch.Tensor,
               zn: torch.Tensor, margins: torch.Tensor, row: int,
               alpha: float, beta: float, l1: float, l2: float,
               chained: bool) -> torch.Tensor:
    """One chunk of the strict FTRL steps in ONE launch: the samples'
    corrections, weights, margins (into ``margins[row:row + K]``) and
    deltas, sample by sample; returns the deltas (2, K * w). Arguments
    and arithmetic as :func:`walk_chunk_plain`. ``xi`` (K, w) int32;
    ``xv``, ``yy``, ``zn`` and ``margins`` of one dtype, float32 or
    float64; K * w at most ``WALK_MAX_POSITIONS``, the scatter-add's
    limit (a chunk too large for shared memory walks from a scratch
    buffer the wrapper allocates). Replaces the per-sample loop around
    ``alink_tpu/kernels/ftrl.py::chained_corr``."""
    if xv.device.type == "cpu":
        return walk_chunk_plain(xi, xv, yy, zn, margins, row, alpha, beta,
                                l1, l2, chained)
    # the checks in one pass, a few attribute reads (the walk is issued
    # once per chunk); the message is built only for a refusal
    index = xv.get_device()
    code = _DTYPE_CODES.get(xv.dtype)
    K, w = xi.shape if xi.dim() == 2 else (0, 0)
    tensors = (xi, xv, yy, zn, margins)
    if (code is None or not xv.is_cuda or xi.dtype is not torch.int32
            or w < 1 or K * w > WALK_MAX_POSITIONS
            or xv.shape != (K, w) or yy.shape != (K,)
            or zn.shape != (K * w, 2) or margins.dim() != 1
            or not 0 <= row <= margins.shape[0] - K
            or margins.numel() >= 2 ** 31
            or any(t.get_device() != index or not t.is_contiguous()
                   for t in tensors)
            or any(t.dtype is not xv.dtype for t in (yy, zn, margins))):
        raise ValueError(
            f"walk_chunk: want contiguous CUDA tensors on one device: (K, w) "
            f"int32 slots with K * w at most {WALK_MAX_POSITIONS}, and "
            f"values (K, w), labels (K,), state "
            f"(K * w, 2) and margins (with rows row .. row + K) of one dtype, "
            f"float32 or float64; got "
            f"{[(t.device, t.dtype, tuple(t.shape)) for t in tensors]} at "
            f"row {row}")
    d = xv.new_empty((2, K * w))
    nbytes = _walk_spill(code, K, w)
    # held until the launch is on the stream; the allocator hands its
    # memory only to later work on that stream
    spill = xv.new_empty(nbytes, dtype=torch.uint8) if nbytes else None
    _launch("ftrl_walk", "alink_ftrl_walk", index, code,
            int(chained), xi.data_ptr(), xv.data_ptr(), yy.data_ptr(),
            zn.data_ptr(), margins.data_ptr() + row * margins.element_size(),
            d.data_ptr(), K, w, float(beta), float(l1), float(l2),
            _reciprocal(alpha, xv.dtype),
            spill.data_ptr() if spill is not None else 0)
    return d
