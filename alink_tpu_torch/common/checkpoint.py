"""Durable, checksummed checkpoint store — the snapshot format every
recovery path shares.

Counterpart: ``alink_tpu/common/checkpoint.py``, copied with the same
on-disk format (name, version, manifest, ``.npy`` leaves, blake2b
digests, atomic publish, retention), so a directory written by either
package validates and loads bit for bit in the other, and the JAX
package's ``tools/ckpt.py`` lists and validates the port's snapshots.

The reference rides Flink's checkpoint/savepoint machinery (SURVEY §1:
the BSP ``IterativeComQueue`` and the FTRL model stream are fault-tolerant
because the runtime underneath them is). The TPU rebuild has no Flink, so
this module is the substrate: a **zero-extra-dependency** on-disk snapshot
format plus the lifecycle helpers (list / latest / validate / prune) that
``engine/recovery.py`` (superstep snapshots), the FTRL trainer (model
state snapshots) and ``CheckpointSinkStreamOp`` (durable micro-batches)
all build on.

Format (one directory per snapshot)::

    <dir>/ckpt-000000000042/
        manifest.json          # written LAST; a snapshot without a valid
                               # manifest does not exist
        arr_00000.npy          # one .npy per payload array leaf
        arr_00001.npy
        ...

``manifest.json``::

    {"format": "alink_tpu_checkpoint", "version": 1, "tag": 42,
     "created_unix": ..., "meta": {...caller JSON...},
     "structure": <pytree skeleton, leaves as {"t":"leaf","i":k}>,
     "arrays": [{"file": "arr_00000.npy", "shape": [...], "dtype": "...",
                 "bytes": n, "blake2b": "<hex digest of the file>"}, ...]}

Durability contract:

  * **atomic publish** — payload + manifest are written into a hidden
    ``.tmp-*`` sibling, fsynced, then the directory is ``os.rename``d
    into place. Readers only ever see complete snapshots; a crash mid-
    write leaves a ``.tmp-*`` dir that listing ignores and ``prune``
    sweeps.
  * **checksummed load** — every array file's blake2b digest, shape and
    dtype must match the manifest; version must be a known one. A failed
    check raises :class:`CheckpointError`; ``latest_checkpoint`` skips
    invalid snapshots and falls back to the newest valid one.
  * **bitwise round-trip** — payloads are ``.npy`` files written with
    ``allow_pickle=False``; float arrays reload bit-identical, which is
    what makes kill-and-resume parity provable (tests/test_checkpoint.py).

Every successful save/load reports into the MetricsRegistry
(``alink_checkpoint_total`` / ``_bytes_total`` / ``_seconds`` /
``_last_tag`` / ``_restore_total``, labelled by ``scope``) and emits a
``checkpoint.save`` / ``checkpoint.restore`` trace instant.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .faults import maybe_crash
from .metrics import get_registry, metrics_enabled
from .tracing import trace_instant

__all__ = [
    "CheckpointError", "FORMAT_NAME", "FORMAT_VERSION",
    "save_checkpoint", "load_checkpoint", "validate_checkpoint",
    "list_checkpoints", "latest_checkpoint", "load_latest_validated",
    "prune_checkpoints", "checkpoint_tag", "read_manifest",
]

FORMAT_NAME = "alink_tpu_checkpoint"
FORMAT_VERSION = 1
MANIFEST = "manifest.json"
_PREFIX = "ckpt-"
_TMP_PREFIX = ".tmp-"


class CheckpointError(RuntimeError):
    """Invalid, corrupted or mismatched snapshot."""


# ---------------------------------------------------------------------------
# pytree <-> (structure json, leaf list)
# ---------------------------------------------------------------------------

def _encode_structure(obj: Any, leaves: List[np.ndarray]) -> Any:
    """JSON skeleton of a payload pytree; array leaves are replaced by
    ``{"t": "leaf", "i": k}`` and collected into ``leaves``. Containers:
    dict (string keys) / list / tuple. Scalars (str/int/float/bool/None)
    stay inline. Anything else is rejected — the format must stay
    readable by any numpy-only process."""
    if isinstance(obj, (np.ndarray, np.generic)) or (
            hasattr(obj, "shape") and hasattr(obj, "dtype")):
        arr = np.asarray(obj)
        if arr.dtype == object:
            raise CheckpointError(
                "checkpoint payload arrays must have a fixed dtype; got an "
                "object array (encode strings as unicode or store them in "
                "meta=)")
        leaves.append(arr)
        return {"t": "leaf", "i": len(leaves) - 1}
    if isinstance(obj, dict):
        for k in obj:
            if not isinstance(k, str):
                raise CheckpointError(
                    f"checkpoint payload dict keys must be str, got "
                    f"{type(k).__name__}")
        return {"t": "dict",
                "v": {k: _encode_structure(v, leaves) for k, v in obj.items()}}
    if isinstance(obj, (list, tuple)):
        return {"t": "list" if isinstance(obj, list) else "tuple",
                "v": [_encode_structure(v, leaves) for v in obj]}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {"t": "scalar", "v": obj}
    raise CheckpointError(
        f"unsupported payload node type {type(obj).__name__}; pass arrays, "
        f"dicts, lists, tuples or JSON scalars")


def _decode_structure(node: Any, leaves: List[np.ndarray]) -> Any:
    t = node.get("t") if isinstance(node, dict) else None
    if t == "leaf":
        return leaves[node["i"]]
    if t == "dict":
        return {k: _decode_structure(v, leaves) for k, v in node["v"].items()}
    if t == "list":
        return [_decode_structure(v, leaves) for v in node["v"]]
    if t == "tuple":
        return tuple(_decode_structure(v, leaves) for v in node["v"])
    if t == "scalar":
        return node["v"]
    raise CheckpointError(f"manifest structure: unknown node {node!r}")


def _fsync_dir(path: str) -> None:
    """fsync a directory's metadata so a just-published rename survives
    power loss (no-op on filesystems/platforms that refuse O_RDONLY
    directory fds)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _digest_file(path: str) -> str:
    h = hashlib.blake2b(digest_size=16)
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def checkpoint_tag(path: str) -> int:
    """Numeric tag of a snapshot directory name (``.../ckpt-42`` -> 42)."""
    base = os.path.basename(os.path.normpath(path))
    if not base.startswith(_PREFIX):
        raise CheckpointError(f"not a checkpoint directory name: {base!r}")
    try:
        return int(base[len(_PREFIX):])
    except ValueError:
        raise CheckpointError(f"non-numeric checkpoint tag in {base!r}")


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------

def save_checkpoint(directory: str, tag: int, payload: Any,
                    meta: Optional[Dict[str, Any]] = None, *,
                    scope: str = "default",
                    keep_last: Optional[int] = None) -> str:
    """Atomically persist ``payload`` (a pytree of arrays) as snapshot
    ``ckpt-<tag>`` under ``directory``; returns the published path.

    ``meta`` is caller JSON stored verbatim in the manifest (resume
    validation data: program signatures, batch counters, ...).
    ``keep_last=N`` prunes older snapshots after a successful publish
    (bounded retention; the just-written snapshot always survives).
    """
    t0 = time.perf_counter()
    tag = int(tag)
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"{_PREFIX}{tag:012d}")
    tmp = os.path.join(directory,
                       f"{_TMP_PREFIX}{_PREFIX}{tag:012d}-{os.getpid()}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    try:
        leaves: List[np.ndarray] = []
        structure = _encode_structure(payload, leaves)
        arrays = []
        total_bytes = 0
        for i, arr in enumerate(leaves):
            fname = f"arr_{i:05d}.npy"
            fpath = os.path.join(tmp, fname)
            with open(fpath, "wb") as f:
                np.save(f, arr, allow_pickle=False)
                f.flush()
                os.fsync(f.fileno())
            total_bytes += os.path.getsize(fpath)
            arrays.append({"file": fname, "shape": list(arr.shape),
                           "dtype": str(arr.dtype),
                           "bytes": os.path.getsize(fpath),
                           "blake2b": _digest_file(fpath)})
        manifest = {"format": FORMAT_NAME, "version": FORMAT_VERSION,
                    "tag": tag, "created_unix": time.time(),
                    "meta": meta or {}, "structure": structure,
                    "arrays": arrays}
        mpath = os.path.join(tmp, MANIFEST)
        with open(mpath, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        # the injected-kill point: a crash here must leave no visible
        # snapshot (the .tmp dir is ignored by every reader)
        maybe_crash("ckpt.save")
        if os.path.exists(final):
            # re-publishing a tag (e.g. a retried save): replace the old
            # snapshot; rename-over-directory is not portable, so swap via
            # a doomed name. The window where ``final`` is absent is
            # tolerated because readers fall back to the previous tag.
            doomed = tmp + ".old"
            os.rename(final, doomed)
            os.rename(tmp, final)
            shutil.rmtree(doomed, ignore_errors=True)
        else:
            os.rename(tmp, final)
        # the rename is only durable once the PARENT's metadata is on
        # disk; without this a power cut after 'publish' could resurface
        # with the snapshot entry missing
        _fsync_dir(directory)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if metrics_enabled():
        reg = get_registry()
        lbl = {"scope": scope}
        reg.inc("alink_checkpoint_total", 1, lbl)
        reg.inc("alink_checkpoint_bytes_total", total_bytes, lbl)
        reg.observe("alink_checkpoint_seconds", time.perf_counter() - t0, lbl)
        reg.set_gauge("alink_checkpoint_last_tag", tag, lbl)
    trace_instant("checkpoint.save", cat="ckpt",
                  args={"scope": scope, "tag": tag, "bytes": total_bytes,
                        "seconds": round(time.perf_counter() - t0, 6)})
    if keep_last is not None:
        prune_checkpoints(directory, keep_last)
    return final


# ---------------------------------------------------------------------------
# load / validate
# ---------------------------------------------------------------------------

def read_manifest(path: str) -> Dict[str, Any]:
    """Parse + shallow-validate a snapshot's manifest (no payload reads)."""
    mpath = os.path.join(path, MANIFEST)
    if not os.path.isfile(mpath):
        raise CheckpointError(f"{path}: no {MANIFEST} (incomplete snapshot)")
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointError(f"{path}: unreadable manifest: {e}")
    if manifest.get("format") != FORMAT_NAME:
        raise CheckpointError(
            f"{path}: not an {FORMAT_NAME} snapshot "
            f"(format={manifest.get('format')!r})")
    if manifest.get("version") != FORMAT_VERSION:
        raise CheckpointError(
            f"{path}: unsupported snapshot version "
            f"{manifest.get('version')!r} (this build reads "
            f"version {FORMAT_VERSION})")
    return manifest


def validate_checkpoint(path: str) -> Dict[str, Any]:
    """Full integrity check (manifest + every array's digest/shape/dtype);
    returns the manifest. Raises :class:`CheckpointError` on any defect."""
    manifest = read_manifest(path)
    for spec in manifest["arrays"]:
        fpath = os.path.join(path, spec["file"])
        if not os.path.isfile(fpath):
            raise CheckpointError(f"{path}: missing payload {spec['file']}")
        if os.path.getsize(fpath) != spec["bytes"]:
            raise CheckpointError(
                f"{path}: {spec['file']} is {os.path.getsize(fpath)} bytes, "
                f"manifest says {spec['bytes']} (truncated?)")
        digest = _digest_file(fpath)
        if digest != spec["blake2b"]:
            raise CheckpointError(
                f"{path}: {spec['file']} checksum mismatch "
                f"({digest} != manifest {spec['blake2b']})")
    return manifest


def load_checkpoint(path: str, *, scope: str = "default",
                    validate: bool = True) -> Tuple[Any, Dict[str, Any]]:
    """Load one snapshot directory; returns ``(payload, meta)``.

    ``validate=True`` (default) checksums every file before deserializing.
    Arrays additionally verify shape/dtype against the manifest after
    ``np.load`` — a tampered-but-redigested file still cannot smuggle a
    different geometry into a resume.
    """
    manifest = validate_checkpoint(path) if validate else read_manifest(path)
    leaves: List[np.ndarray] = []
    for spec in manifest["arrays"]:
        fpath = os.path.join(path, spec["file"])
        try:
            arr = np.load(fpath, allow_pickle=False)
        except (OSError, ValueError) as e:
            raise CheckpointError(f"{path}: cannot load {spec['file']}: {e}")
        if list(arr.shape) != spec["shape"] or str(arr.dtype) != spec["dtype"]:
            raise CheckpointError(
                f"{path}: {spec['file']} is {arr.shape}/{arr.dtype}, "
                f"manifest says {spec['shape']}/{spec['dtype']}")
        leaves.append(arr)
    payload = _decode_structure(manifest["structure"], leaves)
    if metrics_enabled():
        get_registry().inc("alink_checkpoint_restore_total", 1,
                           {"scope": scope})
    trace_instant("checkpoint.restore", cat="ckpt",
                  args={"scope": scope, "tag": manifest.get("tag")})
    return payload, manifest.get("meta", {})


# ---------------------------------------------------------------------------
# listing / retention
# ---------------------------------------------------------------------------

def list_checkpoints(directory: str) -> List[str]:
    """Published snapshot paths under ``directory``, oldest first.
    In-flight ``.tmp-*`` dirs and foreign files are ignored; validity is
    NOT checked (use ``validate_checkpoint`` / ``latest_checkpoint``)."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if not name.startswith(_PREFIX):
            continue
        path = os.path.join(directory, name)
        if not os.path.isdir(path):
            continue
        try:
            tag = checkpoint_tag(path)
        except CheckpointError:
            continue
        out.append((tag, path))
    return [p for _, p in sorted(out)]


def latest_checkpoint(directory: str, *,
                      validate: bool = True) -> Optional[str]:
    """Newest snapshot path, or None. With ``validate=True`` corrupted /
    incomplete snapshots are skipped (newest VALID wins) — the crash-
    during-write recovery guarantee."""
    for path in reversed(list_checkpoints(directory)):
        if not validate:
            return path
        try:
            validate_checkpoint(path)
            return path
        except CheckpointError:
            continue
    return None


def load_latest_validated(directory: str, expected_signature: Any, *,
                          scope: str = "default",
                          what: str = "program"
                          ) -> Optional[Tuple[Any, Dict[str, Any]]]:
    """Newest valid snapshot's ``(payload, meta)``, refusing a resume
    target whose ``meta["signature"]`` differs from ``expected_signature``
    (raises :class:`CheckpointError`); None when the directory holds no
    valid snapshot. The shared resume entry point: validates checksums
    exactly once (``latest_checkpoint`` already digested the winner)."""
    path = latest_checkpoint(directory)
    if path is None:
        return None
    payload, meta = load_checkpoint(path, scope=scope, validate=False)
    got = meta.get("signature")
    if got != expected_signature:
        raise CheckpointError(
            f"{path}: snapshot belongs to a different {what} "
            f"(signature {got!r} != expected {expected_signature!r}); "
            f"refusing to resume — clear the directory or match the "
            f"configuration")
    return payload, meta


def prune_checkpoints(directory: str, keep_last: int) -> List[str]:
    """Delete all but the newest ``keep_last`` snapshots (plus any stale
    ``.tmp-*`` debris); returns the removed paths."""
    if keep_last < 1:
        raise ValueError(f"keep_last must be >= 1, got {keep_last}")
    removed = []
    ckpts = list_checkpoints(directory)
    for path in ckpts[:-keep_last] if keep_last < len(ckpts) else []:
        shutil.rmtree(path, ignore_errors=True)
        removed.append(path)
    if os.path.isdir(directory):
        for name in os.listdir(directory):
            if name.startswith(_TMP_PREFIX):
                shutil.rmtree(os.path.join(directory, name),
                              ignore_errors=True)
                removed.append(os.path.join(directory, name))
    return removed
