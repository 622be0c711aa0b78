"""The native host runtime: C++ parsers and the batch hasher via ctypes.

Counterpart: ``alink_tpu/native/__init__.py``. ``csrc/parser.cpp`` is the
port's own copy of the JAX package's ``parser.cpp`` (LibSVM, numeric CSV
and vector-literal parsers, MurmurHash3 over a packed token buffer, the
compiled single-slot FTRL loop). It is built with the system C++ compiler
(``c++``, then ``g++``) at first use into ``build/libparser-<hash>.so``
at the root of the checkout, where the hash covers the source and the
flags, so a changed source rebuilds. ``-ffp-contract=off`` keeps the
compiler from fusing ``ftrl_slot_run``'s products into FMAs on hosts that
have them (aarch64), so every host gives the same bits.

A failed build raises with the compiler's output: there is no switch that
turns the library off and no pure-Python fallback. A binding returns
``None`` only where the data does not have the shape it asks for
(:func:`parse_libsvm_fb16`), never because the library is absent.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "csrc" / "parser.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
COMPILERS = ("c++", "g++")
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def target() -> Path:
    """The library's path: ``build/libparser-<hash of source and flags>.so``."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libparser-{h.hexdigest()[:16]}.so"


def compile_library(out: Path) -> None:
    """Compile ``csrc/parser.cpp`` into ``out`` with the first compiler of
    :data:`COMPILERS` on the ``PATH``; raises ``RuntimeError`` with the
    compiler's output when none is found or the build fails. Writes a
    pid-suffixed file and renames it, so processes that build at the same
    moment never load a half-written library."""
    cc = next((c for c in map(shutil.which, COMPILERS) if c), None)
    if cc is None:
        raise RuntimeError(f"alink_tpu_torch.native: no C++ compiler found "
                           f"(tried {', '.join(COMPILERS)}); the native "
                           f"parser cannot be built")
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        r = subprocess.run([cc, *FLAGS, str(SRC), "-o", str(tmp)],
                           capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise RuntimeError(
                f"alink_tpu_torch.native: {cc} failed on {SRC.name} (exit "
                f"{r.returncode}):\n{r.stdout}{r.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    c, i64, i32 = ctypes.c_char_p, ctypes.c_int64, ctypes.c_int
    pi64 = ctypes.POINTER(ctypes.c_int64)
    pi32 = ctypes.POINTER(ctypes.c_int32)
    pi16 = ctypes.POINTER(ctypes.c_int16)
    pd = ctypes.POINTER(ctypes.c_double)
    pf32 = ctypes.POINTER(ctypes.c_float)
    dbl = ctypes.c_double
    sig = {
        "svm_count": (i32, [c, i64, pi64, pi64, pi64]),
        "svm_fill": (i32, [c, i64, i64, pd, pi64, pi32, pd]),
        "svm_bounds": (i32, [c, i64, pi64, pi64]),
        "svm_fill2": (i32, [c, i64, i64, pd, pi64, pi32, pd, pi64, pi64,
                            pi64]),
        "svm_fill_fb16": (i32, [c, i64, i64, i64, i64, pf32, pi16, pi64]),
        "csv_dims": (i32, [c, i64, ctypes.c_char, pi64, pi64]),
        "csv_fill": (i32, [c, i64, ctypes.c_char, i64, pd]),
        "vec_count": (i32, [c, i64, pi64, pi64, pi64]),
        "vec_fill": (i32, [c, i64, pi64, pi32, pd]),
        "vec_bounds": (i32, [c, i64, pi64, pi64]),
        "vec_fill2": (i32, [c, i64, pi64, pi32, pd, pi64, pi64, pi64]),
        "murmur_batch": (i64, [c, pi64, i64, ctypes.c_uint32, i64, pi64]),
        "ftrl_slot_run": (i64, [pi32, pd, pd, i64, i64, dbl, dbl, dbl, dbl,
                                pd, pd]),
    }
    for name, (res, args) in sig.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if ``build/`` does not hold the
    current source's build. Builds under a file lock, so the processes
    of a parallel test run compile once."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = target()
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            with open(BUILD_DIR / "libparser.lock", "w") as lk:
                fcntl.flock(lk, fcntl.LOCK_EX)
                if not out.exists():
                    compile_library(out)
        _lib = _declare(ctypes.CDLL(str(out)))
        return _lib


def _p(arr, typ):
    return arr.ctypes.data_as(ctypes.POINTER(typ))


def _trim(arrs):
    """Trimmed views pin their upper-bound buffers: copy the ones that
    use under half of theirs, so the oversized allocation is freed."""
    return tuple(a.copy() if a.base is not None and
                 a.nbytes < 0.5 * a.base.nbytes else a for a in arrs)


def parse_libsvm_bytes(data: bytes, start_index: int = 1
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                  np.ndarray]:
    """(labels, indptr, indices, values) CSR arrays of LibSVM lines.

    One pass: ``svm_bounds`` sizes the buffers from cheap byte counts
    (rows <= newlines, nnz <= colons), ``svm_fill2`` parses once and
    reports the real counts, then the views are trimmed."""
    lib = get_lib()
    rows_ub, nnz_ub = ctypes.c_int64(), ctypes.c_int64()
    lib.svm_bounds(data, len(data), ctypes.byref(rows_ub),
                   ctypes.byref(nnz_ub))
    labels = np.empty(rows_ub.value, np.float64)
    indptr = np.empty(rows_ub.value + 1, np.int64)
    indices = np.empty(nnz_ub.value, np.int32)
    values = np.empty(nnz_ub.value, np.float64)
    rows, nnz, mx = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    lib.svm_fill2(data, len(data), start_index, _p(labels, ctypes.c_double),
                  _p(indptr, ctypes.c_int64), _p(indices, ctypes.c_int32),
                  _p(values, ctypes.c_double), ctypes.byref(rows),
                  ctypes.byref(nnz), ctypes.byref(mx))
    return _trim((labels[:rows.value], indptr[:rows.value + 1],
                  indices[:nnz.value], values[:nnz.value]))


def parse_libsvm_fb16(data: bytes, n_fields: int, field_size: int,
                      start_index: int = 1
                      ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """The field-blocked parse: (labels float32, fb int16 ``(rows,
    n_fields)``) of LibSVM rows that hold one value 1.0 a field, field
    by field; ``None`` when the rows do not have that shape or
    ``field_size`` does not fit int16 (the caller parses with
    :func:`parse_libsvm_bytes` then). One pass, 2-byte ids: the
    disk-to-device fast path."""
    if field_size > np.iinfo(np.int16).max:
        return None       # the fill would truncate larger field-local ids
    lib = get_lib()
    rows_ub, nnz_ub = ctypes.c_int64(), ctypes.c_int64()
    lib.svm_bounds(data, len(data), ctypes.byref(rows_ub),
                   ctypes.byref(nnz_ub))
    if nnz_ub.value > rows_ub.value * n_fields:
        return None       # a cheap screen; the fill validates exactly
    labels = np.empty(rows_ub.value, np.float32)
    fb = np.empty((rows_ub.value, n_fields), np.int16)
    rows = ctypes.c_int64()
    rc = lib.svm_fill_fb16(data, len(data), start_index, n_fields,
                           field_size, _p(labels, ctypes.c_float),
                           _p(fb, ctypes.c_int16), ctypes.byref(rows))
    if rc != 0:
        return None
    return _trim((labels[:rows.value], fb[:rows.value]))


def ftrl_slot_run(idx: np.ndarray, val: np.ndarray, y: np.ndarray,
                  z: np.ndarray, n: np.ndarray, alpha: float, beta: float,
                  l1: float, l2: float) -> None:
    """The compiled single-slot strict FTRL loop, in place, over a padded
    COO micro-batch (``idx``/``val`` shaped (rows, width), padding with
    ``val == 0``): mutates ``z`` and ``n`` (float64, contiguous)."""
    idx = np.ascontiguousarray(idx, np.int32)
    val = np.ascontiguousarray(val, np.float64)
    y = np.ascontiguousarray(y, np.float64)
    if idx.ndim != 2 or val.shape != idx.shape or y.shape != idx.shape[:1]:
        raise ValueError(f"ftrl_slot_run: idx {idx.shape}, val {val.shape} "
                         f"and y {y.shape} do not match")
    for s in (z, n):
        if s.dtype != np.float64 or not s.flags.c_contiguous \
                or s.ndim != 1:
            raise ValueError("ftrl_slot_run: z and n must be contiguous "
                             "1-d float64")
    if idx.size and (idx.min() < 0 or idx.max() >= min(len(z), len(n))):
        raise ValueError("ftrl_slot_run: a slot lies outside z / n")
    rows, width = idx.shape
    get_lib().ftrl_slot_run(
        _p(idx, ctypes.c_int32), _p(val, ctypes.c_double),
        _p(y, ctypes.c_double), rows, width, float(alpha), float(beta),
        float(l1), float(l2), _p(z, ctypes.c_double), _p(n, ctypes.c_double))


def split_newline_chunks(data: bytes, k: int) -> List[bytes]:
    """Split ``data`` into at most ``k`` newline-aligned chunks (no line
    is split). Chunk i starts at the first line whose first byte lies at
    or after ``len * i // k``: the ownership rule of
    ``io/sharding.read_file_shard``."""
    n = len(data)
    if k <= 1 or n == 0:
        return [data] if n else []
    starts = [0]
    for i in range(1, k):
        pos = n * i // k
        if pos == 0 or data[pos - 1:pos] == b"\n":
            start = pos   # pos itself starts a line: it belongs to chunk i
        else:
            nl = data.find(b"\n", pos)
            start = n if nl < 0 else nl + 1
        if start > starts[-1]:
            starts.append(start)
    starts.append(n)
    return [data[starts[i]:starts[i + 1]]
            for i in range(len(starts) - 1) if starts[i + 1] > starts[i]]


def parse_libsvm_bytes_parallel(data: bytes, start_index: int = 1,
                                max_workers: Optional[int] = None
                                ) -> Tuple[np.ndarray, np.ndarray,
                                           np.ndarray, np.ndarray]:
    """:func:`parse_libsvm_bytes` over newline-aligned chunks (about 4 MB
    each, at most one a core) on a thread pool; the ctypes calls release
    the GIL. The chunks' CSR arrays join with one concatenate each, the
    indptr shifted by the earlier chunks' non-zeros."""
    k = min(os.cpu_count() or 1, max(1, len(data) >> 22))
    if max_workers is not None:
        k = min(k, max_workers)
    if k <= 1:
        return parse_libsvm_bytes(data, start_index)
    chunks = split_newline_chunks(data, k)
    from ..operator.stream.prefetch import prefetch_map
    parts = list(prefetch_map(
        iter(chunks), lambda c: parse_libsvm_bytes(c, start_index),
        workers=len(chunks)))
    labels = np.concatenate([p[0] for p in parts])
    indices = np.concatenate([p[2] for p in parts])
    values = np.concatenate([p[3] for p in parts])
    nnz_offs = np.cumsum([0] + [len(p[2]) for p in parts[:-1]])
    indptr = np.concatenate(
        [parts[0][1][:1]] + [p[1][1:] + off for p, off in zip(parts, nnz_offs)])
    return labels, indptr, indices, values


def parse_numeric_csv_bytes(data: bytes, delim: str = ",") -> np.ndarray:
    """(rows, cols) float64 matrix of numeric CSV, NaN for empty cells."""
    if len(delim.encode()) != 1:
        raise ValueError(f"a one-byte delimiter is needed, got {delim!r}")
    lib = get_lib()
    rows, cols = ctypes.c_int64(), ctypes.c_int64()
    d = ctypes.c_char(delim.encode())
    lib.csv_dims(data, len(data), d, ctypes.byref(rows), ctypes.byref(cols))
    out = np.empty((rows.value, cols.value), np.float64)
    lib.csv_fill(data, len(data), d, cols.value, _p(out, ctypes.c_double))
    return out


def murmur32_batch(tokens, seed: int = 0, mod: int = 0) -> np.ndarray:
    """MurmurHash3 x86 32 of each byte-string token in one C call over a
    packed buffer: int64 hashes, the raw uint32 range when ``mod <= 0``,
    else ``% mod``.

    A fixed-width ``S`` array packs without a Python loop. Such an array
    cannot tell a token's trailing NUL bytes from its padding, so they
    are not hashed (text never carries them); ``np.char.str_len`` keeps
    the embedded ones."""
    if isinstance(tokens, np.ndarray) and tokens.dtype.kind == "S":
        n = len(tokens)
        w = tokens.dtype.itemsize
        lens = np.char.str_len(tokens).astype(np.int64)
        bytes2d = np.frombuffer(np.ascontiguousarray(tokens).tobytes(),
                                np.uint8).reshape(n, w)
        buf = bytes2d[np.arange(w) < lens[:, None]].tobytes()
    else:
        lens = np.fromiter((len(t) for t in tokens), np.int64, len(tokens))
        buf = b"".join(tokens)
    offsets = np.zeros(len(tokens) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    out = np.empty(len(tokens), np.int64)
    get_lib().murmur_batch(buf, _p(offsets, ctypes.c_int64), len(tokens),
                           seed & 0xFFFFFFFF, mod, _p(out, ctypes.c_int64))
    return out


def parse_vector_lines(data: bytes) -> Tuple[np.ndarray, np.ndarray,
                                             np.ndarray, int]:
    """(indptr, indices, values, dim) CSR arrays of newline-separated
    sparse-vector literals (``$n$i:v ...``, ``i:v ...``, commas allowed
    between pairs). The one-pass protocol of :func:`parse_libsvm_bytes`.
    A blank line makes no row."""
    lib = get_lib()
    rows_ub, nnz_ub = ctypes.c_int64(), ctypes.c_int64()
    lib.vec_bounds(data, len(data), ctypes.byref(rows_ub),
                   ctypes.byref(nnz_ub))
    indptr = np.empty(rows_ub.value + 1, np.int64)
    indices = np.empty(nnz_ub.value, np.int32)
    values = np.empty(nnz_ub.value, np.float64)
    rows, nnz, mx = ctypes.c_int64(), ctypes.c_int64(), ctypes.c_int64()
    lib.vec_fill2(data, len(data), _p(indptr, ctypes.c_int64),
                  _p(indices, ctypes.c_int32), _p(values, ctypes.c_double),
                  ctypes.byref(rows), ctypes.byref(nnz), ctypes.byref(mx))
    arrs = _trim((indptr[:rows.value + 1], indices[:nnz.value],
                  values[:nnz.value]))
    return (*arrs, int(mx.value))
