"""The ordered row scatter-add, "P3": CUDA wrapper and plain version.

No TPU kernel is replaced here. The JAX package adds wide rows into a
state with XLA scatter-adds: Word2Vec's ``e["in"].at[c].add`` and
``e["out"].at[pt].add`` (``alink_tpu/operator/common/nlp/word2vec.py``),
FM's sparse gradient (``operator/common/fm/fm.py::_fm_grads``) and LDA's
``jax.ops.segment_sum`` (``operator/common/clustering/lda.py``). On the
card PyTorch's ``index_add_`` adds with atomics, so two trainings would
not give the same bits, and the port's other ordered kernels stop at two
columns (``kernels/ftrl.py::scatter_add_rows``, ``kernels/linear.py::
scatter_walk``). :func:`scatter_rows` is a CUDA kernel written by hand for
Hopper (``csrc/row_scatter.cu``) that adds in a fixed order instead;
:func:`scatter_rows_plain` is its plain version. Given CPU tensors the
wrapper runs the plain version; given CUDA tensors it launches the kernel
or raises.

**Contract.** ``state[keys[m], :] += terms[m, :]`` for m in order, in
place, one rounded add each; a row that no key names keeps its bits.
``state`` (S, C), float32 or float64, any C >= 1. On the CPU this is what
the JAX package's ``.at[].add`` and ``segment_sum`` compute.

**Two launches by size.** Up to :data:`SMALL_MAX` keys over at most
:data:`SMALL_MAX_ROWS` rows (Word2Vec's batches, FM's and LDA's small
inputs) one launch with no plan and no host read: a grid of
:func:`small_blocks` blocks, a set of them for each key set k % G and
one of the set for each column group, each reading every key and sorting
its own positions by key in shared memory (a stable counting sort), then
walking its runs. Above it the run plan
of ``kernels/linear.py::run_plan`` (one call of ``csrc/run_plan.cu``)
and a grid of warps over its runs, longest first. Both walk a run in
chunks of positions, all of a chunk's term loads before its adds, and
give a warp two runs at 16 columns or fewer (:func:`lane_split`: FM's
12 columns), one above. Word2Vec's loop issues from one host thread, so
its scatters stay off the plan, whose six launches cost more host time
than a walk saves (``PERF.md``), up to a vocabulary of
:data:`SMALL_MAX_ROWS` words: the one launch's key sets grow with the
rows, each block reading every key, and at 2^19 rows of 100 columns it
takes 0.121 ms of device time against the plan's 0.063, at 1.5 M 0.32
(an NVIDIA H100 80GB HBM3 at 700 W, ``PERF.md``).

The earlier design put each run on one warp with its lanes over 32
columns, and below :data:`SMALL_MAX` all of it on one block of one SM: at
Word2Vec's ``out`` scatter (3,840 x 100, key 0's run 1,608 long) the
walk took 97 % of the one block's 0.50 ms and its sort 1.3 %. This one
takes 0.029-0.031 ms of device time there and 0.005-0.008 at ``in``,
where the first took 0.42 and 0.016; LDA's statistics 0.063 against
0.099, FM's gradient walk 0.163 against 0.177 (FM's 3.9 M rows gathered
at random; an NVIDIA H100 80GB HBM3 at 700 W, ``PERF.md``).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Callable, Dict, Optional, Tuple

import torch

from . import _build

__all__ = ["scatter_rows", "scatter_rows_plain", "row_plan", "lane_split",
           "small_blocks", "walk_blocks", "launch_counts",
           "reset_launch_counts", "SMALL_MAX", "SMALL_MAX_ROWS"]

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}
SMALL_MAX = 11264           # csrc/row_scatter.cu kSmallMaxM
_SMALL_KEYS = 1024          # csrc/row_scatter.cu kMaxLocalKeys
# the small path's states at most: above, its key sets of at most
# _SMALL_KEYS rows each, every one reading all the keys, take longer than
# the plan's path (PERF.md)
SMALL_MAX_ROWS = 1 << 18
_SMALL_POSITIONS = 16       # positions a key set at the least
_WALK_WARPS = 8             # csrc/row_scatter.cu kThreads / 32
_WALK_BLOCKS_PER_SM = 8


def scatter_rows_plain(state: torch.Tensor, keys: torch.Tensor,
                       terms: torch.Tensor) -> torch.Tensor:
    """``state[keys[m]] += terms[m]`` for m in order, in place; returns
    ``state``: ``index_add_``, which on the CPU adds the rows in position
    order, one rounded add a column (``tests/test_torch_row_scatter.py``
    pins it to a Python loop of the contract, to the JAX package and to
    ``kernels/ftrl.py::scatter_add_rows_plain``'s rounds). On the card
    ``index_add_`` adds with atomics, so the plain version is held on the
    CPU (``chip_smoke.py`` compares the kernel with it on CPU copies). A
    key outside ``[0, S)`` raises ``IndexError``."""
    if keys.numel() and (int(keys.min()) < 0
                         or int(keys.max()) >= state.shape[0]):
        raise IndexError(f"scatter_rows: keys outside [0, "
                         f"{state.shape[0]})")
    return state.index_add_(0, keys.long(), terms)


def lane_split(C: int) -> Tuple[int, int, int]:
    """``(q, ncg, cw)``: a warp walks ``q`` runs at once, a group of ``32
    // q`` lanes each, a run in ``ncg`` tasks of ``cw`` columns. Above 16
    columns one run a warp, the columns in the fewest groups of at most 32
    as even as they go (100: four of 25); else two runs a warp (FM's 12
    columns: 5 % off its walk against one run a warp on an NVIDIA H100
    80GB HBM3 at 700 W, ``PERF.md``)."""
    if C > 16:
        ncg = -(-C // 32)
        return 1, ncg, -(-C // ncg)
    return 2, 1, C


def small_blocks(sms: int, M: int, S: int, ncg: int) -> int:
    """Blocks of the small path over ``M`` keys in ``[0, S)`` on ``sms``
    SMs, ``ncg`` column groups a run (:func:`lane_split`): ``ncg`` blocks
    a key set (k % sets), one a group; as many sets as the SMs hold such
    ``ncg`` blocks, but no more than one a 16 positions, and at least
    enough that no set has more than 1,024 keys."""
    sets = max(min(max(sms // ncg, 1), -(-M // _SMALL_POSITIONS)),
               -(-S // _SMALL_KEYS))
    return sets * ncg


def _small(M: int, S: int) -> bool:
    return M <= SMALL_MAX and S <= SMALL_MAX_ROWS


def walk_blocks(sms: int, M: int) -> int:
    """Blocks of the plan walk over ``M`` positions on ``sms`` SMs: a
    warp a run at the most (there are at most ``M`` runs), at most 8
    blocks an SM, the warps striding over the rest."""
    return max(1, min(-(-M // _WALK_WARPS), sms * _WALK_BLOCKS_PER_SM))


# launch counts: kept without a lock, as the other wrappers keep theirs
_counts: Dict[str, int] = {"row_scatter": 0}
_lib_lock = threading.Lock()
_fns: Optional[Dict[str, Callable[..., int]]] = None
_sms: Dict[int, int] = {}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset (the plan's are
    ``kernels/linear.py``'s ``run_plan``)."""
    return dict(_counts)


def reset_launch_counts() -> None:
    for k in _counts:
        _counts[k] = 0


def _functions() -> Dict[str, Callable[..., int]]:
    """The built ``row_scatter`` library's C functions, resolved once."""
    global _fns
    if _fns is not None:
        return _fns
    with _lib_lock:
        if _fns is None:
            lib = _build.load_library("row_scatter")
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.alink_row_scatter_small.argtypes = [i, p, p, p, i, i, i, i,
                                                    i, i, i, p]
            lib.alink_row_scatter_small.restype = i
            lib.alink_row_scatter_walk.argtypes = [i, p, p, p, p, p, p, p, i,
                                                   i, i, i, i, i, p]
            lib.alink_row_scatter_walk.restype = i
            lib.alink_row_scatter_error_string.argtypes = [i]
            lib.alink_row_scatter_error_string.restype = ctypes.c_char_p
            _fns = {"small": lib.alink_row_scatter_small,
                    "walk": lib.alink_row_scatter_walk,
                    "error_string": lib.alink_row_scatter_error_string}
        return _fns


def _sm_count(index: int) -> int:
    sms = _sms.get(index)
    if sms is None:
        sms = _sms[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return sms


def row_plan(keys: torch.Tensor, size: int):
    """The run plan :func:`scatter_rows` walks for ``keys`` (M,) int32
    in ``[0, size)`` on the card: ``kernels/linear.py::run_plan`` above
    :data:`SMALL_MAX` keys or :data:`SMALL_MAX_ROWS` rows, ``None`` below
    them and on the CPU (no plan is walked there). A caller whose keys do not change between calls (FM's
    design, LDA's corpus) builds it once."""
    if keys.device.type == "cpu" or _small(keys.numel(), size):
        return None
    from .linear import run_plan
    return run_plan(keys, size)


def scatter_rows(state: torch.Tensor, keys: torch.Tensor,
                 terms: torch.Tensor, plan=None) -> torch.Tensor:
    """``state[keys[m], :] += terms[m, :]`` for every m in order, one
    rounded add each, IN PLACE; returns ``state``. ``state`` (S, C)
    contiguous, float32 or float64; ``keys`` (M,) int32 in ``[0, S)``;
    ``terms`` (M, C) of the state's dtype. On the card: the small path's
    one launch (M up to :data:`SMALL_MAX`, S up to
    :data:`SMALL_MAX_ROWS`), or the run plan (``plan``, :func:`row_plan` of
    these keys, built here when not given) and its walk, with no host
    read; on the CPU the plain version."""
    if state.device.type == "cpu":
        return scatter_rows_plain(state, keys, terms)
    code = _DTYPE_CODES.get(state.dtype)
    index = state.get_device()
    M = keys.shape[0] if keys.dim() == 1 else -1
    if (code is None or state.dim() != 2 or keys.dtype != torch.int32
            or M < 0 or terms.dtype != state.dtype
            or tuple(terms.shape) != (M, state.shape[1])
            or state.shape[1] < 1 or state.numel() >= 2 ** 31
            or terms.numel() >= 2 ** 31
            or any(t.get_device() != index or not t.is_contiguous()
                   for t in (state, keys, terms))):
        raise ValueError(
            f"scatter_rows: want a contiguous (S, C) float32 or float64 "
            f"state, (M,) int32 keys and (M, C) terms of its dtype on its "
            f"device; got state {state.dtype} {tuple(state.shape)}, keys "
            f"{keys.dtype} {tuple(keys.shape)} on {keys.device}, terms "
            f"{terms.dtype} {tuple(terms.shape)} on {terms.device}")
    if M == 0:
        return state
    S, C = state.shape
    fns = _fns or _functions()
    if _small(M, S):
        q, ncg, cw = lane_split(C)
        rc = _build.call(fns["small"], index, code, state.data_ptr(),
                         keys.data_ptr(), terms.data_ptr(), M, S, C, q, ncg,
                         cw, small_blocks(_sm_count(index), M, S, ncg))
    else:
        if plan is None:
            plan = row_plan(keys, S)
        elif plan.perm.shape[0] != M or plan.perm.get_device() != index:
            raise ValueError(f"scatter_rows: the plan is not one of these "
                             f"{M} keys on {state.device}")
        rc = _build.call(fns["walk"], index, code, state.data_ptr(),
                         plan.perm.data_ptr(), plan.starts.data_ptr(),
                         plan.order.data_ptr(), plan.slots.data_ptr(),
                         plan.counts.data_ptr(), terms.data_ptr(), S, C,
                         *lane_split(C), walk_blocks(_sm_count(index), M))
    if rc != 0:
        msg = fns["error_string"](rc).decode()
        raise RuntimeError(f"scatter_rows: kernel launch failed: CUDA error "
                           f"{rc} ({msg})")
    _counts["row_scatter"] += 1
    return state
