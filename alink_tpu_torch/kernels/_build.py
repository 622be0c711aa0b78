"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

No counterpart in ``alink_tpu`` (Pallas kernels compile through XLA).
Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/lib<name>-<hash>.so`` at the root of the checkout, at first
use, from the sources in the repository only. The hash covers the
source files and the flags, so a changed source rebuilds. A failed
build raises with the compiler's output; nothing falls back.

Run ``python -m alink_tpu_torch.kernels._build`` to build every source
(in parallel, one ``nvcc`` each) and print the compiler's resource
report.

The launch side is shared too: :func:`call` runs a library function on
a device's current stream, with the two lookups every launch makes kept
cheap (:func:`current_device`, and :func:`stream_handle`, the raw
handle of the current stream without a ``torch.cuda.Stream`` object).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    """The names of every CUDA source under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("alink_tpu_torch: nvcc not found (PATH, CUDA_HOME or "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be "
                       "built")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, out: Path) -> subprocess.Popen:
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, out: Path, proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    out.with_suffix(".log").write_text(log)
    return log


def build(names: Sequence[str] = ()) -> Dict[str, str]:
    """Build the named sources (default: all) that are not built yet,
    one ``nvcc`` per source, all started together. Returns each built
    source's compiler output."""
    names = list(names) or sources()
    with _lock:
        todo = [(n, _target(n)) for n in names if not _target(n).exists()]
        if not todo:
            return {}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = [(n, out, _start(n, out)) for n, out in todo]
        return {n: _finish(n, out, proc) for n, out, proc in procs}


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
    if lib is not None:
        return lib
    build([name])
    with _lock:
        if name not in _loaded:
            _loaded[name] = ctypes.CDLL(str(_target(name)))
        return _loaded[name]


def build_log(name: str) -> str:
    """The compiler's output of the current build of ``name``."""
    log = _target(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


_raw_stream: Optional[Callable[[int], int]] = None


def current_device() -> int:
    """The index of the current CUDA device."""
    return torch._C._cuda_getDevice()


def stream_handle(index: int) -> int:
    """The ``cudaStream_t`` of device ``index``'s current stream, as an
    int for ctypes: PyTorch's raw-stream lookup where the build has it,
    else ``torch.cuda.current_stream(index).cuda_stream``."""
    global _raw_stream
    if _raw_stream is None:
        _raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) \
            or (lambda i: torch.cuda.current_stream(i).cuda_stream)
    return _raw_stream(index)


def call(fn: Callable[..., int], index: int, *args: int) -> int:
    """``fn(*args, stream)`` on device ``index``'s current stream, the
    device entered only when it is not the current one; returns ``fn``'s
    CUDA error code."""
    if index != current_device():
        with torch.cuda.device(index):
            return fn(*args, stream_handle(index))
    return fn(*args, stream_handle(index))


if __name__ == "__main__":
    build()
    for n in sources():
        print(f"== csrc/{n}.cu -> {_target(n)}\n{build_log(n)}")
