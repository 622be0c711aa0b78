"""The sparse design products of linear training: the ordered gradient
kernel, its plan and plain version, and the margins; and the ordered
scatter-add of FTRL's batch step, which walks its runs the same way.

No TPU kernel is replaced here. The JAX package computes the gradient
``X^T c`` of a padded-COO design with an XLA scatter-add
(``alink_tpu/operator/common/optim/objfunc.py::rmatvec``) and of a
field-blocked one with a one-hot product
(``alink_tpu/ops/fieldblock.py::fb_rmatvec``). On the card PyTorch's
``index_add_`` adds with atomics, so two trainings would not give the
same bits; :func:`linear_grad` is a CUDA kernel written by hand for
Hopper (``csrc/linear_grad.cu``) that adds in a fixed order instead.
:func:`linear_grad_plain` is its plain version. Given CPU tensors the
wrapper runs the plain version; given CUDA tensors it launches the
kernel or raises.

**Contract.** ``grad[s] = sum val[i, k] * c[i]`` over the positions
``(i, k)`` with ``keys[i, k] == s``: each product rounded on its own,
then added in flattened (row, column) order from ``+0.0``. On the CPU
that is what the JAX package's scatter-add computes and what
``index_add_`` computes, which is the plain version (pinned to a Python
loop by ``tests/test_torch_linear_grad.py``). The plain version is
ordered on the CPU only; on the card ``index_add_`` is the library call
the kernel is timed against.

**The plan** (:func:`run_plan`, shared by both kernels) is over the
distinct keys of the positions it is given, so its work and memory
follow the keys, not the state: the positions stably sorted by key
(``perm``), each distinct key's run in it (``starts``) and its key
(``slots``), the runs in the kernel's order (``order``: runs of more
than :data:`SHORT_MAX` terms by length, longest first, then the rest by
key), and ``counts``, a device tensor of the runs, the heavy runs (at
least :data:`HEAVY_MIN` terms: each walked by a cluster of two blocks,
one walker thread fed by a block of producer warps), the medium runs
(more than :data:`SHORT_MAX`: a warp each) and the short rest (a lane
each). On the card it is one launch of ``csrc/run_plan.cu`` (a radix
sort, then the runs, one cooperative grid), and the kernels read ``counts``
from device memory, so nothing waits for the card: the launch grids come
from upper bounds of the positions (:func:`launch_grid`). Its plain
version, :func:`run_plan_plain` (torch ops and one host read), is the
CPU's plan. :func:`grad_plan` keeps a design's keys and values beside
the plan of its keys, built once a training (the key layout does not
change between supersteps) or once an FTRL micro-batch; the gradient
kernel writes each run at its slot of a zeroed vector, so a slot no key
names is ``+0.0``.

:func:`sparse_margins` is the forward product ``eta[i] = sum_k
val[i, k] * w[keys[i, k]]``: the sparse serving score kernel
(``kernels/serve.py::sparse_scores`` in ``f32`` mode, zero bias), each
row's terms added left to right from zero, so training margins equal
served scores.

**The ordered scatter-add** (:func:`scatter_walk`, "P2", the same CUDA
source's second kernel) replaces no TPU kernel either: it is FTRL's
batch update ``z.at[li].add(dz)``, ``n.at[li].add(dn)`` (the JAX
package's ``_ftrl_sparse_batch_step_factory``, an XLA scatter-add) at
micro-batch scale, where the one-block ``kernels/ftrl.py::
scatter_add_rows`` stops at 11,264 updates. Contract: ``z[key] +=
dz`` and ``n[key] += dn`` for every position in flattened order, one
rounded add each, in place, both in one launch; a slot no key names
keeps its bits. Its plain version is ``kernels/ftrl.py::
scatter_add_rows_plain``, which holds the JAX package's ``.at[].add``
bitwise. Its plan is built every micro-batch (:func:`run_plan`; each
run starts from the stored value and is written back at its slot). The
wrapper sits here, beside P1's, because it shares P1's library, plan,
run walk, grid and classes of runs.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from . import _build
from .ftrl import scatter_add_rows_plain
from .serve import sparse_scores

__all__ = ["RunPlan", "run_plan", "run_plan_plain", "plan_counts",
           "GradPlan", "grad_plan", "linear_grad", "linear_grad_plain",
           "sparse_margins", "scatter_walk", "scatter_walk_plain",
           "launch_counts", "reset_launch_counts", "HEAVY_MIN", "SHORT_MAX"]

_DTYPE_CODES = {torch.float32: 0, torch.float64: 1}
HEAVY_MIN = 2048            # a heavy run's least length: two of P1's stages
SHORT_MAX = 32              # a short run's most length: one lane walks it
#                             (both compiled into csrc/run_plan.cu too)
_WARPS = 8                  # warps a light block (csrc/linear_grad.cu kWarps)
_BLOCKS_PER_SM = 8          # light blocks an SM (2048 threads; registers may
#                             allow fewer)
_PLAN_THREADS = 512         # csrc/run_plan.cu kThreads
PLAN_MIN_CHUNK = 4096       # positions a plan block takes at the least: up
#                             to it the plan is one block, its data in
#                             shared memory (PERF.md §6)
_SORT_MAX_BITS = 9          # csrc/run_plan.cu kMaxDigitBits
_PLAN_DIGITS = 1 << _SORT_MAX_BITS
_PLAN_BLK = 5               # csrc/run_plan.cu kBlk


class RunPlan(NamedTuple):
    """The runs of a set of keys (one device): the distinct keys in key
    order, each run's positions in flattened order, the runs in the
    kernel's order. The arrays have the keys' length ``M``; the first
    ``runs`` entries (``runs + 1`` of ``starts``) are the plan, the rest
    is not defined on the card. ``counts`` stays on the keys' device:
    :func:`plan_counts` reads it."""
    perm: torch.Tensor      # (M,) int32 positions stably sorted by key
    starts: torch.Tensor    # (M + 1,) int32: run r is
    #                         perm[starts[r]:starts[r + 1]]
    order: torch.Tensor     # (M,) int32 runs: heavy and medium by length,
    #                         longest first (ties by run), then the short
    #                         ones by run
    slots: torch.Tensor     # (M,) int32: run r's key
    counts: torch.Tensor    # (4,) int32: runs, heavy runs (at least
    #                         HEAVY_MIN terms), medium runs (the other runs
    #                         of more than SHORT_MAX), short runs


def plan_counts(plan: RunPlan) -> Tuple[int, int, int, int]:
    """``(runs, n_heavy, n_medium, n_short)`` as ints: a host read of a
    card plan (for checks and records, never on the main path)."""
    runs, n_heavy, n_medium, n_short = plan.counts.tolist()
    return runs, n_heavy, n_medium, n_short


def _check_sizes(M: int, size: int) -> None:
    if M >= 2 ** 31 or size >= 2 ** 31:
        raise ValueError(f"run_plan: {M} keys over {size} slots exceed "
                         f"the kernel's int sizes")


def _empty_plan(dev) -> RunPlan:
    empty = torch.zeros(0, dtype=torch.int32, device=dev)
    return RunPlan(empty, torch.zeros(1, dtype=torch.int32, device=dev),
                   empty, empty, torch.zeros(4, dtype=torch.int32,
                                             device=dev))


def run_plan_plain(keys: torch.Tensor, size: int) -> RunPlan:
    """The plan of the keyed sums at ``keys`` (any shape, integer, in
    ``[0, size)``) with torch ops on the keys' device: a stable sort of
    the flat keys, their runs (a run id by a running count of the key
    changes, each run's length by an integer scatter-add, the starts by a
    running sum) and the runs in the kernel's order by a second stable
    sort. One host read: the counts and the keys' range; a key outside
    ``[0, size)`` raises ``IndexError``. No keys: a plan of no runs. The
    CPU's plan, and what the card's is held to."""
    flat = keys.reshape(-1)
    M = flat.numel()
    _check_sizes(M, size)
    dev = flat.device
    if M == 0:
        return _empty_plan(dev)
    sk, perm = torch.sort(flat, stable=True)
    head = torch.ones(M, dtype=torch.bool, device=dev)
    torch.ne(sk[1:], sk[:-1], out=head[1:])
    rid = torch.cumsum(head, 0) - 1                    # int64 run ids
    counts = torch.zeros(M, dtype=torch.int32, device=dev).scatter_add_(
        0, rid, torch.ones(M, dtype=torch.int32, device=dev))
    starts = torch.zeros(M + 1, dtype=torch.int32, device=dev)
    torch.cumsum(counts, 0, out=starts[1:])
    slots = sk[starts[:-1].clamp(max=M - 1).long()]
    # heavy and medium runs by length, longest first; short runs after them
    # in run order (the runs past the last have no terms and sort last), so
    # a warp's lanes read neighbouring bounds and runs
    order = torch.sort(torch.where(counts > SHORT_MAX, -counts, 0),
                       stable=True).indices
    runs, n_heavy, n_long, lo, hi = torch.stack([
        rid[-1] + 1, (counts >= HEAVY_MIN).sum(), (counts > SHORT_MAX).sum(),
        sk[0].long(), sk[-1].long()]).tolist()
    if lo < 0 or hi >= size:
        raise IndexError(f"run_plan: keys outside [0, {size})")
    return RunPlan(perm.to(torch.int32), starts, order.to(torch.int32),
                   slots.to(torch.int32),
                   torch.tensor([runs, n_heavy, n_long - n_heavy,
                                 runs - n_long], dtype=torch.int32,
                                device=dev))


def plan_grid(M: int, sms: int) -> Tuple[int, int]:
    """``(chunk, blocks)`` of the card's plan over ``M > 0`` positions on
    a card of ``sms`` SMs: one cooperative launch of blocks of ``chunk``
    positions (a multiple of the kernel's 512 threads, at least
    :data:`PLAN_MIN_CHUNK`), at most one block an SM, the last one
    partial. Up to :data:`PLAN_MIN_CHUNK` positions that is one block."""
    per = max(PLAN_MIN_CHUNK, -(-M // max(1, sms)))
    chunk = -(-per // _PLAN_THREADS) * _PLAN_THREADS
    return chunk, -(-M // chunk)


def sort_digits(size: int) -> Tuple[int, int]:
    """``(passes, bits)`` of the card's radix sort of keys in ``[0,
    size)``: the fewest passes of at most 9 bits that cover the bits of
    ``size - 1`` (at least one pass), the bits spread evenly."""
    need = max(0, size - 1).bit_length()
    passes = max(1, -(-need // _SORT_MAX_BITS))
    return passes, max(1, -(-need // passes))


@functools.lru_cache(maxsize=256)
def _plan_layout(M: int, size: int, sms: int) -> Tuple[int, ...]:
    """``(chunk, blocks, passes, bits, sizes)`` of the card's plan: its
    grid, its sort's digits, and the lengths of the views of its one
    int32 buffer (``csrc/run_plan.cu::alink_run_plan``): perm, starts,
    slots, order, counts, then the kernel's scratch (the sorted keys, the
    long runs and their lengths, the histogram, the digit totals, the
    blocks' values)."""
    chunk, blocks = plan_grid(M, sms)
    passes, bits = sort_digits(size)
    cap = M // (SHORT_MAX + 1) + 1
    scratch = (M + 2 * cap + (_PLAN_DIGITS + _PLAN_BLK) * blocks
               + _PLAN_DIGITS)
    return chunk, blocks, passes, bits, (M, M + 1, M, M, 4, scratch)


def run_plan(keys: torch.Tensor, size: int) -> RunPlan:
    """The plan of the keyed sums at ``keys`` (any shape, in ``[0,
    size)``) on the keys' device. On the card (int32 keys): one launch of
    ``csrc/run_plan.cu`` into one int32 buffer (the plan's arrays are
    views of it, beside the kernel's scratch): a stable radix sort of the
    flat keys with their positions (:func:`sort_digits`), then the runs
    (heads, a scan, the long runs sorted by length over the blocks, the
    counts), with no host read: a key outside ``[0, size)`` fails a
    device-side assert, which the stream reports at its next synchronize.
    On the CPU: :func:`run_plan_plain`, which raises ``IndexError``. No
    keys: a plan of no runs."""
    if keys.device.type == "cpu":
        return run_plan_plain(keys, size)
    flat = keys.reshape(-1).contiguous()
    M = flat.numel()
    _check_sizes(M, size)
    if flat.dtype != torch.int32:
        raise ValueError(f"run_plan: want int32 keys on the card, got "
                         f"{flat.dtype}")
    if M == 0:
        return _empty_plan(flat.device)
    index = flat.get_device()
    chunk, blocks, passes, bits, sizes = _plan_layout(M, int(size),
                                                      _sm_count(index))
    buf = torch.empty(sum(sizes), dtype=torch.int32, device=flat.device)
    perm, starts, slots, order, counts, _ = buf.split_with_sizes(sizes)
    fns = _fns or _functions()
    rc = _build.call(fns["plan"], index, flat.data_ptr(), M, int(size),
                     chunk, blocks, passes, bits, buf.data_ptr(), buf.numel())
    if rc != 0:
        msg = fns["plan_error_string"](rc).decode()
        raise RuntimeError(f"run_plan: kernel launch failed: CUDA error "
                           f"{rc} ({msg})")
    _counts["run_plan"] += 1
    return RunPlan(perm, starts, order, slots, counts)


class GradPlan(NamedTuple):
    """A sparse design (one device) and the run plan of its keys."""
    keys: torch.Tensor      # (n, width) int32 slots, contiguous
    val: torch.Tensor       # (n, width) values, contiguous
    dim: int                # the gradient's slots
    walk: RunPlan           # the runs of ``keys``


def grad_plan(keys: torch.Tensor, dim: int, val: torch.Tensor) -> GradPlan:
    """The plan of a design with ``keys`` (n, width) in ``[0, dim)`` and
    values ``val`` (n, width), on the keys' device: the keys, the values
    and :func:`run_plan` of the keys. A key outside ``[0, dim)`` raises
    ``IndexError``."""
    if keys.dim() != 2:
        raise ValueError(f"grad_plan: keys {tuple(keys.shape)}; want (n, w)")
    if val.shape != keys.shape:
        raise ValueError(f"grad_plan: values {tuple(val.shape)} vs keys "
                         f"{tuple(keys.shape)}")
    keys = keys.to(torch.int32).contiguous()
    return GradPlan(keys, val.contiguous(), int(dim), run_plan(keys, dim))


def linear_grad_plain(plan: GradPlan, c: torch.Tensor) -> torch.Tensor:
    """``grad[s] = sum val * c`` as ``index_add_`` adds it: on the CPU in
    flattened position order from ``+0.0``, the contract's order."""
    terms = (plan.val * c[:, None]).reshape(-1)
    return torch.zeros(plan.dim, dtype=terms.dtype,
                       device=terms.device).index_add_(
        0, plan.keys.reshape(-1).long(), terms)


# launch counts: kept without a lock, as the other wrappers keep theirs
_counts: Dict[str, int] = {"linear_grad": 0, "scatter_walk": 0,
                           "run_plan": 0}
_lib_lock = threading.Lock()
_fns: Optional[Dict[str, Callable[..., int]]] = None
_sms: Dict[int, int] = {}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return dict(_counts)


def reset_launch_counts() -> None:
    for k in _counts:
        _counts[k] = 0


def _functions() -> Dict[str, Callable[..., int]]:
    """The built ``linear_grad`` and ``run_plan`` libraries' C functions,
    resolved once."""
    global _fns
    if _fns is not None:
        return _fns
    with _lib_lock:
        if _fns is None:
            lib = _build.load_library("linear_grad")
            plan = _build.load_library("run_plan")
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.alink_linear_grad.argtypes = [i, i, p, p, p, p, p, p, p, p,
                                              ctypes.c_uint, i, i, i, p]
            lib.alink_linear_grad.restype = i
            lib.alink_scatter_walk.argtypes = [i, i, p, p, p, p, p, p, p, p,
                                               i, i, p]
            lib.alink_scatter_walk.restype = i
            lib.alink_linear_error_string.argtypes = [i]
            lib.alink_linear_error_string.restype = ctypes.c_char_p
            plan.alink_run_plan.argtypes = [p, i, i, i, i, i, i, p,
                                            ctypes.c_longlong, p]
            plan.alink_run_plan.restype = i
            plan.alink_run_plan_error_string.argtypes = [i]
            plan.alink_run_plan_error_string.restype = ctypes.c_char_p
            _fns = {"grad": lib.alink_linear_grad,
                    "scatter": lib.alink_scatter_walk,
                    "error_string": lib.alink_linear_error_string,
                    "plan": plan.alink_run_plan,
                    "plan_error_string": plan.alink_run_plan_error_string}
        return _fns


@functools.lru_cache(maxsize=None)
def div_magic(width: int) -> Tuple[int, int]:
    """``(magic, shift)`` with ``p // width == (p * magic) >> shift`` for
    every ``0 <= p < 2**31``: ``shift = 31 + ceil(log2 width)``, ``magic =
    ceil(2**shift / width) < 2**32`` (Granlund and Montgomery's round-up
    method at 31-bit numerators). The kernel's row of a position."""
    if not 0 < width < 2 ** 31:
        raise ValueError(f"div_magic: width {width}")
    shift = 31 + (width - 1).bit_length()
    return -(-(1 << shift) // width), shift


def launch_grid(sms: int, M: int) -> Tuple[int, int]:
    """``(heavy_blocks, light_blocks)`` of the walk of a plan over ``M``
    positions on a card of ``sms`` SMs, from upper bounds (the host does
    not read the plan's counts; a block with no work leaves). A heavy run
    has at least ``HEAVY_MIN`` positions, so there are at most ``M //
    HEAVY_MIN`` of them, each walked by a cluster of two blocks that hold
    an SM alone: at most a quarter of the SMs' clusters, which then take
    several runs each. A light block's 8 warps take a medium run each or
    32 short runs each, so ``M / 256`` blocks have a run a warp or a lane
    at the most; at most 8 an SM, striding over the rest (beside a heavy
    walk one light block an SM works and the others leave at once)."""
    clusters = min(M // HEAVY_MIN, max(1, sms // 4))
    light = max(1, min(-(-M // (32 * _WARPS)), sms * _BLOCKS_PER_SM))
    return 2 * clusters, light


def _sm_count(index: int) -> int:
    sms = _sms.get(index)
    if sms is None:
        sms = _sms[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return sms


def _grid(index: int, M: int) -> Tuple[int, int]:
    return launch_grid(_sm_count(index), M)


def linear_grad(plan: GradPlan, c: torch.Tensor) -> torch.Tensor:
    """``grad = X^T c`` of the plan's design, ``(dim,)`` in the values'
    dtype: the ordered gradient kernel on the card (into a zeroed vector,
    each run stored at its slot), its plain version on the CPU. ``c`` (n,)
    must have the values' dtype."""
    if c.device.type == "cpu":
        return linear_grad_plain(plan, c)
    val, walk = plan.val, plan.walk
    code = _DTYPE_CODES.get(val.dtype)
    index = val.get_device()
    if (code is None or c.dtype != val.dtype or c.dim() != 1
            or c.shape[0] != val.shape[0] or not c.is_contiguous()
            or any(t.get_device() != index for t in (c, walk.perm,
                                                     walk.starts, walk.order,
                                                     walk.slots,
                                                     walk.counts))):
        raise ValueError(f"linear_grad: want c ({val.shape[0]},) of "
                         f"{val.dtype} on {val.device} (float32 or "
                         f"float64), got {c.dtype} {tuple(c.shape)} on "
                         f"{c.device}")
    out = torch.zeros(plan.dim, dtype=val.dtype, device=val.device)
    M = walk.perm.shape[0]
    if M == 0:
        return out
    fns = _fns or _functions()
    rc = _build.call(fns["grad"], index, index, code, walk.perm.data_ptr(),
                     walk.starts.data_ptr(), walk.order.data_ptr(),
                     walk.slots.data_ptr(), walk.counts.data_ptr(),
                     val.data_ptr(), c.data_ptr(), out.data_ptr(),
                     *div_magic(max(1, val.shape[1])), *_grid(index, M))
    if rc != 0:
        msg = fns["error_string"](rc).decode()
        raise RuntimeError(f"linear_grad: kernel launch failed: CUDA error "
                           f"{rc} ({msg})")
    _counts["linear_grad"] += 1
    return out


_zero_bias: Dict[tuple, torch.Tensor] = {}


def sparse_margins(keys: torch.Tensor, val: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """``eta[i] = sum_k val[i, k] * w[keys[i, k]]`` in ``val``'s dtype,
    each row added left to right from zero: the sparse score kernel
    (``f32`` mode) with a zero bias on the card, its plain version on
    the CPU."""
    key = (val.device, val.dtype)
    b = _zero_bias.get(key)
    if b is None:
        b = _zero_bias[key] = torch.zeros(1, dtype=val.dtype,
                                          device=val.device)
    return sparse_scores((w, b), keys, val, "f32")


def scatter_walk_plain(z: torch.Tensor, n: torch.Tensor, keys: torch.Tensor,
                       terms: torch.Tensor) -> None:
    """``z[key] += terms[..., 0]`` and ``n[key] += terms[..., 1]`` for
    each position in flattened order, in place
    (``kernels/ftrl.py::scatter_add_rows_plain`` on each state): the
    contract, on any device."""
    flat = keys.reshape(-1)
    for q, st in enumerate((z, n)):
        scatter_add_rows_plain(st, flat, terms[..., q].reshape(-1))


def scatter_walk(z: torch.Tensor, n: torch.Tensor, keys: torch.Tensor,
                 terms: torch.Tensor,
                 plan: Optional[RunPlan] = None) -> None:
    """``z[key] += terms[..., 0]`` and ``n[key] += terms[..., 1]`` for
    every position of ``keys`` in flattened (row-major) order, one rounded
    add each, IN PLACE; a slot no key names keeps its bits. ``z``, ``n``
    (S,) contiguous, of one dtype (float32 or float64); ``keys`` int32 of
    any shape, in ``[0, S)``; ``terms`` of the states' dtype and shape
    ``keys.shape + (2,)``. The ordered scatter-add kernel on the card
    (both states in one walk: the heavy clusters and the light blocks, two
    launches from upper bounds of the positions, after the plan of
    :func:`run_plan`, built here unless ``plan``, the keys', is given;
    nothing waits for the card), its plain version on the CPU."""
    if (z.dim() != 1 or n.shape != z.shape or n.dtype != z.dtype
            or terms.dtype != z.dtype or keys.dtype != torch.int32
            or tuple(terms.shape) != tuple(keys.shape) + (2,)):
        raise ValueError(
            f"scatter_walk: want (S,) z and n of one dtype, int32 keys and "
            f"terms of shape keys + (2,); got z {z.dtype} "
            f"{tuple(z.shape)}, n {n.dtype} {tuple(n.shape)}, keys "
            f"{keys.dtype} {tuple(keys.shape)}, terms {terms.dtype} "
            f"{tuple(terms.shape)}")
    if z.device.type == "cpu":
        scatter_walk_plain(z, n, keys, terms)
        return
    code = _DTYPE_CODES.get(z.dtype)
    index = z.get_device()
    terms = terms.contiguous()
    if (code is None or any(t.get_device() != index or not t.is_contiguous()
                            for t in (z, n, keys, terms))
            or terms.data_ptr() % (2 * terms.element_size())
            or z.numel() >= 2 ** 31):
        raise ValueError(f"scatter_walk: want contiguous float32 or float64 "
                         f"z, n, keys and terms on {z.device}")
    M = keys.numel()
    if M == 0:
        return
    if plan is None:
        plan = run_plan(keys, z.shape[0])
    elif plan.perm.shape[0] != M or any(
            t.get_device() != index for t in plan):
        raise ValueError(f"scatter_walk: the plan is not one of these "
                         f"{M} keys on {z.device}")
    fns = _fns or _functions()
    rc = _build.call(fns["scatter"], index, index, code, plan.perm.data_ptr(),
                     plan.starts.data_ptr(), plan.order.data_ptr(),
                     plan.slots.data_ptr(), plan.counts.data_ptr(),
                     terms.data_ptr(), z.data_ptr(), n.data_ptr(),
                     *_grid(index, M))
    if rc != 0:
        msg = fns["error_string"](rc).decode()
        raise RuntimeError(f"scatter_walk: kernel launch failed: CUDA error "
                           f"{rc} ({msg})")
    _counts["scatter_walk"] += 1
