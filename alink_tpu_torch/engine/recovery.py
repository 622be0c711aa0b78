"""ComQueue superstep recovery — durable snapshots and resumable runs.

Counterpart: ``alink_tpu/engine/recovery.py``. The reference's
``IterativeComQueue`` is fault-tolerant because Flink checkpoints its
iterative dataflow; a preempted TaskManager restarts from the last
completed checkpoint. The JAX package gets the same property by running
its compiled superstep loop in chunks and persisting the carry between
them. The port's engine runs its loop eagerly, so there is nothing to
chunk: at every ``every``-th superstep boundary, and at the final state,
the carry is copied to the host and published through
``common/checkpoint.py``. ``resume_from=`` loads the newest valid
snapshot, checks it against the program's signature (:func:`program_
signature`: worker count, ``max_iter``, seed, the inputs' shapes and
dtypes, the broadcast names, the stage names and order, the program key
and a content hash of the data) and re-enters the loop at ``step + 1``
from the restored carry. The snapshot round-trips bit for bit and the
supersteps are deterministic (``ComContext.rng`` derives from the seed,
the step and the task), so the resumed run's final state is the
uninterrupted run's, bit for bit.

What a snapshot holds: every carry entry — tensors (restored as tensors
on the session's device, dtype kept), numpy arrays, JSON scalars (the
L-BFGS ring's ``pos`` and ``nvalid`` are host ints) and lists, tuples
and string-keyed dicts of them. Entries a stage stores with
``ComContext.put_derived`` (data-derived objects such as a design's
gradient plan) are not snapshotted: a stage rebuilds them on the first
superstep a run executes (``ComContext.is_entry_step``). Any other value
raises :class:`~alink_tpu_torch.common.checkpoint.CheckpointError` at the
boundary.

Overlap (``ALINK_TPU_ASYNC_SNAPSHOT``, default on): at a boundary the
loop clones the carry's tensors on the current stream, records a CUDA
event and goes on with the next superstep; a background writer (ONE
snapshot in flight) makes its side stream wait on that event, copies the
clones into pinned host buffers, waits for the copy and publishes. The
writer commits strictly in order, its failure fails the run at the next
boundary (or at the end), and the loop waits for it before returning,
so the snapshots on disk are the same files as the synchronous path's.

``on_snapshot(host, step)`` — the health watchdog's hook — fires after
each publish with the host payload the snapshot has just fetched (from
the writer thread when the writer is on; its error then fails the run
at the next boundary, with that snapshot on disk). With health probes on
the signature carries ``health_probes``: a probe-less snapshot is not
resumed by a probed program, nor the reverse.

Telemetry, as in the JAX package: a ``snapshot.write`` span a background
write, ``alink_overlap_snapshot_writes_total`` and
``alink_overlap_submit_wait_seconds`` (the loop's wait for the previous
write) with the ``snapshot.submit`` instant; ``common/checkpoint.py``
reports every save and load. Not ported: the chunked and lowered
programs and donation. Every snapshot's fetch and write times, its
bytes, and every resume's load time are also kept in a process-wide
record (:func:`snapshot_records`), which the metrics do not split.
"""

from __future__ import annotations

import hashlib
import queue
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..common.checkpoint import (CheckpointError, load_latest_validated,
                                 read_manifest, save_checkpoint)
from ..common.faults import maybe_crash
from ..common.metrics import get_registry, metrics_enabled
from ..common.tracing import trace_instant, trace_span

__all__ = ["CheckpointConfig", "program_signature", "data_digest",
           "resume_state", "drive", "async_snapshot_enabled",
           "snapshot_records", "reset_snapshot_records", "record",
           "payload_bytes"]

SCOPE = "comqueue"
SITE = "comqueue.superstep"
# a numpy array in the carry: kept apart from tensors in the payload so it
# comes back as a numpy array
_HOST = "__ndarray__"


@dataclass(frozen=True)
class CheckpointConfig:
    """Engine checkpoint knobs (``IterativeComQueue.set_checkpoint``).

    ``every``      — persist the carry at every superstep boundary that is
                     a multiple of this (and at the final state);
    ``directory``  — snapshot root (one ``ckpt-<step>`` dir per snapshot);
                     ``None`` runs the boundaries WITHOUT persistence —
                     the boundary-driven mode of
                     ``IterativeComQueue.set_boundary``;
    ``keep_last``  — bounded retention, pruned after each publish;
    ``resume_from``— directory to resume from (usually == ``directory``);
                     the newest VALID snapshot wins; a signature mismatch
                     fails loudly instead of resuming the wrong program.
    """
    directory: Optional[str]
    every: int = 1
    keep_last: int = 3
    resume_from: Optional[str] = None

    def __post_init__(self):
        if int(self.every) < 1:
            raise ValueError(f"checkpoint_every must be >= 1, "
                             f"got {self.every}")
        if int(self.keep_last) < 1:
            # fail at construction, not mid-training from inside the
            # first snapshot's prune
            raise ValueError(f"checkpoint_keep must be >= 1, "
                             f"got {self.keep_last}")


def program_signature(*, num_workers: int, max_iter: int, seed: int,
                      part_sig: Tuple, bcast_names: Tuple,
                      stages_digest: Any, program_key: Any = None,
                      data_token: Optional[str] = None,
                      probes_on: bool = False) -> Dict[str, Any]:
    """JSON identity of the superstep program a snapshot belongs to. A
    resume target must match exactly: same worker count, same input
    geometry, same stages in the same order, same program key — otherwise
    the carry would be fed to a different program and the bitwise
    contract would silently turn into garbage. ``data_token``
    (:func:`data_digest`) fingerprints the training data, so a finished
    run's final snapshot is never 'resumed' as done for other data of the
    same geometry. ``probes_on`` adds ``health_probes``, as in the JAX
    package (emitted only when on, so probe-less snapshots keep their
    signature): the probe series are carry entries, so a probe-less
    snapshot must not resume a probed program, nor the reverse."""
    stages = hashlib.blake2b(repr(stages_digest).encode(),
                             digest_size=12).hexdigest()
    sig = {"kind": "comqueue_carry", "num_workers": int(num_workers),
           "max_iter": int(max_iter), "seed": int(seed),
           "parts": [list(map(str, item)) for item in part_sig],
           "bcast": [str(n) for n in bcast_names],
           "stages_blake2b": stages}
    if probes_on:
        sig["health_probes"] = True
    if program_key is not None:
        sig["program_key_blake2b"] = hashlib.blake2b(
            repr(program_key).encode(), digest_size=12).hexdigest()
    if data_token is not None:
        sig["data_blake2b"] = data_token
    return sig


def data_digest(inputs: Dict[str, Any]) -> str:
    """blake2b of the inputs' names, shapes, dtypes and bytes (tensors on
    a device are read to the host once), recursing into dicts, lists and
    tuples; other values hash by ``repr``."""
    h = hashlib.blake2b(digest_size=12)

    def feed(v):
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        if isinstance(v, np.ndarray):
            a = np.ascontiguousarray(v)
            h.update(f"nd{a.shape}{a.dtype.str}".encode())
            h.update(a.view(np.uint8).reshape(-1).data if a.size else b"")
        elif isinstance(v, dict):
            for k in sorted(v, key=str):
                h.update(f"k{k!r}".encode())
                feed(v[k])
        elif isinstance(v, (list, tuple)):
            h.update(f"s{len(v)}".encode())
            for x in v:
                feed(x)
        else:
            h.update(f"v{v!r}".encode())

    feed(inputs)
    return h.hexdigest()


def async_snapshot_enabled() -> bool:
    """``ALINK_TPU_ASYNC_SNAPSHOT`` (default on): persist boundary
    snapshots from a background writer instead of blocking the loop on
    the device-to-host copy and the file writes. Off writes them in line
    (the same files)."""
    from ..common.flags import flag_value
    return bool(flag_value("ALINK_TPU_ASYNC_SNAPSHOT"))


# ---------------------------------------------------------------------------
# the process-wide snapshot record
# ---------------------------------------------------------------------------

_RECORDS: List[Dict[str, Any]] = []
_RECORDS_LOCK = threading.Lock()


def record(**fields) -> None:
    """Append one snapshot or resume record (``scope``, ``what``: "save"
    or "load", times in ms, ``bytes``, the tag); thread-safe."""
    with _RECORDS_LOCK:
        _RECORDS.append(dict(fields))


def snapshot_records() -> List[Dict[str, Any]]:
    """Every record since the last :func:`reset_snapshot_records`."""
    with _RECORDS_LOCK:
        return [dict(r) for r in _RECORDS]


def reset_snapshot_records() -> None:
    with _RECORDS_LOCK:
        _RECORDS.clear()


# ---------------------------------------------------------------------------
# carry <-> snapshot payload
# ---------------------------------------------------------------------------

def _map_carry(v, on_tensor, on_array, where: str):
    """Rebuild a carry value with tensors through ``on_tensor`` and numpy
    arrays through ``on_array``; JSON scalars, lists, tuples and str-keyed
    dicts are kept; anything else raises CheckpointError."""
    if isinstance(v, torch.Tensor):
        return on_tensor(v)
    if isinstance(v, np.ndarray):
        return on_array(v)
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if type(v) in (list, tuple):
        return type(v)(_map_carry(x, on_tensor, on_array, where) for x in v)
    if type(v) is dict:
        return {k: _map_carry(x, on_tensor, on_array, f"{where}.{k}")
                for k, x in v.items()}
    raise CheckpointError(
        f"carry entry {where!r} holds a {type(v).__name__}, which a "
        f"snapshot cannot hold; store tensors, arrays or JSON scalars, or "
        f"keep a data-derived object out of the carry with "
        f"ComContext.put_derived")


def carry_to_host(carry: Dict[str, Any]) -> Dict[str, Any]:
    """The snapshot payload of a carry: tensors as host numpy arrays (one
    blocking copy each), numpy arrays wrapped so they restore as numpy."""
    def tensor(t):
        if t.dtype == torch.bfloat16:
            raise CheckpointError("a bfloat16 tensor has no numpy dtype; "
                                  "a snapshot cannot hold it")
        return t.detach().cpu().numpy()
    return {k: _map_carry(v, tensor, lambda a: {_HOST: np.array(a)}, k)
            for k, v in carry.items()}


def carry_from_host(payload: Dict[str, Any],
                    device: torch.device) -> Dict[str, Any]:
    """The carry of a snapshot payload: arrays as tensors on ``device``
    (dtype kept), wrapped arrays as numpy arrays."""
    def back(v):
        if isinstance(v, np.ndarray):
            return torch.from_numpy(np.array(v)).to(device)
        if type(v) is dict and set(v) == {_HOST}:
            return np.array(v[_HOST])
        if type(v) in (list, tuple):
            return type(v)(back(x) for x in v)
        if type(v) is dict:
            return {k: back(x) for k, x in v.items()}
        return v
    return {k: back(v) for k, v in payload.items()}


def _device_copy(carry: Dict[str, Any]):
    """Clones of the carry's tensors, queued on the current stream (the
    next superstep may update the originals in place), and the CUDA event
    recorded after them (None when no tensor is on a CUDA device)."""
    cuda = []

    def clone(t):
        c = t.detach().clone()
        if c.is_cuda:
            cuda.append(c.device)
        return c
    copy = {k: _map_carry(v, clone, np.array, k) for k, v in carry.items()}
    event = None
    if cuda:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(cuda[0]))
    return copy, event


class _SnapshotWriter:
    """Bounded background snapshot writer — ONE snapshot in flight.

    ``submit()`` hands over a device-side copy of the carry and its
    event, and returns once the PREVIOUS snapshot has committed (the
    loop runs at most one boundary ahead of durability). The worker
    thread makes its own stream wait on the event, copies every tensor
    into a pinned host buffer on that stream, synchronizes the stream,
    publishes through ``save_checkpoint``, then fires ``on_snapshot``:
    commits are strictly in submission order. Any exception — an
    injected ``ckpt.save`` kill, a watchdog ``HealthAlertError``, a real
    IO error — is kept and re-raised ON THE LOOP'S THREAD (the original
    object) at the next ``submit()`` or ``barrier()``."""

    def __init__(self, config: CheckpointConfig, signature: Dict[str, Any],
                 on_snapshot: Optional[Callable] = None):
        self._config = config
        self._signature = signature
        self._on_snapshot = on_snapshot
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._errs: list = []
        self._stream = None
        self._th = threading.Thread(target=self._worker, daemon=True,
                                    name="alink-ckpt-writer")
        self._th.start()

    def _fetch(self, copy, event):
        if event is None:
            return carry_to_host(copy)

        def pinned(t):
            if not t.is_cuda:
                return t
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            return h
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=event.device)
        # the clones were queued on the loop's stream: this stream waits
        # for them, and the host reads the pinned buffers only after it
        # has synchronized with this stream
        with torch.cuda.stream(self._stream):
            self._stream.wait_event(event)
            staged = {k: _map_carry(v, pinned, lambda a: a, k)
                      for k, v in copy.items()}
        self._stream.synchronize()
        return carry_to_host(staged)

    def _worker(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                copy, event, step, stopped = item
                with trace_span("snapshot.write", cat="ckpt") as sp:
                    t0 = time.perf_counter()
                    host = self._fetch(copy, event)
                    del copy
                    t1 = time.perf_counter()
                    path = save_checkpoint(
                        self._config.directory, step, host,
                        meta={"signature": self._signature, "step": step,
                              "stopped": stopped},
                        scope=SCOPE, keep_last=self._config.keep_last)
                    t2 = time.perf_counter()
                    sp.set(step=step, mode="async")
                record(scope=SCOPE, what="save", tag=step, mode="async",
                       fetch_ms=(t1 - t0) * 1e3, write_ms=(t2 - t1) * 1e3,
                       bytes=payload_bytes(path))
                if metrics_enabled():
                    get_registry().inc("alink_overlap_snapshot_writes_total",
                                       1, {"scope": SCOPE})
                if self._on_snapshot is not None:
                    # the watchdog hook: a HealthAlertError lands in _errs
                    # and fails the run at the next boundary, with this
                    # snapshot already on disk
                    self._on_snapshot(host, step)
            except BaseException as e:
                self._errs.append(e)
            finally:
                self._q.task_done()

    def check(self):
        """Re-raise the first captured writer exception."""
        if self._errs:
            raise self._errs[0]

    def submit(self, carry, step: int, stopped: bool):
        copy, event = _device_copy(carry)
        t0 = time.perf_counter()
        self._q.join()       # the previous snapshot commits first (bound)
        wait = time.perf_counter() - t0
        self.check()         # a failed previous write aborts HERE
        if metrics_enabled():
            get_registry().observe("alink_overlap_submit_wait_seconds",
                                   wait, {"scope": SCOPE})
        trace_instant("snapshot.submit", cat="ckpt",
                      args={"step": step, "waited_s": round(wait, 6)})
        self._q.put((copy, event, step, stopped))

    def barrier(self):
        """Every submitted snapshot is on disk (or its error raised)."""
        self._q.join()
        self.check()

    def shutdown(self):
        """Stop the worker without raising (the ``finally`` path); a
        queued snapshot is still committed first."""
        self._q.put(None)
        self._th.join(timeout=60.0)


def payload_bytes(path: str) -> int:
    """The array files' bytes of a published snapshot, from its manifest."""
    return int(sum(a["bytes"] for a in read_manifest(path)["arrays"]))


def resume_state(config: CheckpointConfig, signature: Dict[str, Any]
                 ) -> Optional[Tuple[Dict[str, Any], Dict[str, Any]]]:
    """``(payload, meta)`` of the newest valid snapshot in
    ``config.resume_from``, checked against ``signature``; None when
    there is nothing to resume from."""
    if not config.resume_from:
        return None
    t0 = time.perf_counter()
    got = load_latest_validated(config.resume_from, signature, scope=SCOPE,
                                what="program")
    if got is not None:
        record(scope=SCOPE, what="load", tag=int(got[1]["step"]),
               load_ms=(time.perf_counter() - t0) * 1e3)
    return got


def drive(config: CheckpointConfig, *, superstep: Callable[[int], bool],
          criterion: Callable[[int], bool], carry: Dict[str, Any],
          max_iter: int, signature: Optional[Dict[str, Any]],
          device: torch.device,
          resumed: Optional[Tuple[Dict[str, Any], Dict[str, Any]]] = None,
          on_boundary: Optional[Callable] = None,
          on_snapshot: Optional[Callable] = None) -> int:
    """Run the superstep loop with host-side persistence.

    ``superstep(step)`` runs every stage of superstep ``step`` on
    ``carry`` (updated in place) and returns its stop bit;
    ``criterion(step)`` re-reads the stop bit of the carry as it stands.
    ``resumed`` is :func:`resume_state`'s result: the carry is restored
    from it and the loop re-enters at ``step + 1``. At every boundary (a
    multiple of ``config.every``, and the final state) the fault site
    ``comqueue.superstep`` fires BEFORE the publish, so a killed run
    genuinely loses the work since its last snapshot.

    ``on_boundary(carry, step)`` — if given — runs at every boundary
    after the snapshot is handed over (and once right after a resume,
    before any new superstep) and may return a replacement carry
    (``None`` keeps it); the stop bit is then re-read. A resumed run
    re-derives the same deterministic boundary decisions. With
    ``config.directory`` None nothing is persisted.
    ``on_snapshot(host, step)`` — if given — fires after each publish
    with the snapshot's host payload. Returns the superstep count."""
    every = int(config.every)
    max_iter = int(max_iter)
    writer = _SnapshotWriter(config, signature, on_snapshot) \
        if (async_snapshot_enabled() and config.directory) else None

    def persist(step, stopped):
        if not config.directory:
            return
        if writer is not None:
            writer.submit(carry, step, stopped)
            return
        t0 = time.perf_counter()
        host = carry_to_host(carry)
        t1 = time.perf_counter()
        path = save_checkpoint(config.directory, step, host,
                               meta={"signature": signature, "step": step,
                                     "stopped": stopped},
                               scope=SCOPE, keep_last=config.keep_last)
        record(scope=SCOPE, what="save", tag=step, mode="sync",
               fetch_ms=(t1 - t0) * 1e3,
               write_ms=(time.perf_counter() - t1) * 1e3,
               bytes=payload_bytes(path))
        if on_snapshot is not None:
            on_snapshot(host, step)

    try:
        if resumed is None:
            step = 1
            stop = superstep(1)
            last_saved = None
        else:
            payload, meta = resumed
            carry.clear()
            carry.update(carry_from_host(payload, device))
            step = last_saved = int(meta["step"])
            stop = bool(meta["stopped"])
        while True:
            done = stop or step >= max_iter
            if done or step % every == 0 or step == last_saved:
                maybe_crash(SITE, step)
                if step != last_saved:
                    persist(step, done)
                    last_saved = step
                if on_boundary is not None and not done:
                    new = on_boundary(carry, step)
                    if new is not None:
                        if new is not carry:
                            carry.clear()
                            carry.update(new)
                        stop = criterion(step)
                        done = stop
            if done:
                break
            step += 1
            stop = superstep(step)
        if writer is not None:
            writer.barrier()
    finally:
        if writer is not None:
            writer.shutdown()
    return step
