"""The port's checkpoint store and fault injection against the JAX
package's, on the CPU.

``alink_tpu_torch/common/checkpoint.py`` and ``common/faults.py`` are
copies of the JAX package's modules (without its metrics and tracing).
Every case of the JAX package's ``TestFormat`` and ``TestFaults``
(``tests/test_checkpoint.py``) runs here against both packages, as
parametrised cases: the bitwise round trip; corrupted, truncated and
manifest-less snapshots rejected; ``latest_checkpoint`` skipping an
invalid snapshot; ``.tmp-*`` debris ignored and pruned; retention; object
arrays rejected; a crash in ``ckpt.save`` leaving no snapshot; the fault
thresholds and sites, and an unarmed site costing nothing. Then the
format across the two packages: a snapshot the port writes loads bit for
bit through the JAX package's ``load_checkpoint`` and the reverse, and
the JAX package's ``tools/ckpt.py`` lists and validates a directory the
port wrote (an engine run's snapshots).
"""

import importlib.util
import os

import numpy as np
import pytest

import alink_tpu.common.checkpoint as jck
import alink_tpu.common.faults as jfaults
import alink_tpu_torch.common.checkpoint as tck
import alink_tpu_torch.common.faults as tfaults

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": (jck, jfaults), "torch": (tck, tfaults)}


@pytest.fixture(params=sorted(PACKAGES))
def pkg(request):
    """One package's (checkpoint module, faults module)."""
    return PACKAGES[request.param]


PAYLOAD = {
    "z": np.arange(12, dtype=np.float32).reshape(3, 4),
    "nested": {"k": np.float64(3.5) * np.ones(5),
               "ints": np.arange(4, dtype=np.int32)},
    "mixed": [np.ones((2, 2)), ("tag", 7, None, 2.5)],
}


# ---------------------------------------------------------------------------
# the format (the JAX package's TestFormat, in both packages)
# ---------------------------------------------------------------------------

def test_round_trip_bitwise(pkg, tmp_path):
    ck, _ = pkg
    meta = {"signature": {"kind": "demo"}, "step": 9}
    path = ck.save_checkpoint(str(tmp_path), 9, PAYLOAD, meta=meta)
    assert os.path.basename(path) == "ckpt-000000000009"
    payload, got_meta = ck.load_checkpoint(path)
    assert got_meta == meta
    assert payload["z"].tobytes() == PAYLOAD["z"].tobytes()
    assert payload["z"].dtype == np.float32
    assert payload["nested"]["k"].dtype == np.float64
    assert payload["mixed"][1] == ("tag", 7, None, 2.5)  # tuple preserved
    np.testing.assert_array_equal(payload["mixed"][0], np.ones((2, 2)))


def test_corrupted_payload_rejected(pkg, tmp_path):
    ck, _ = pkg
    path = ck.save_checkpoint(str(tmp_path), 1, PAYLOAD)
    target = os.path.join(path, "arr_00000.npy")
    with open(target, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        f.write(b"\x7f")
    with pytest.raises(ck.CheckpointError, match="checksum mismatch"):
        ck.load_checkpoint(path)


def test_truncated_payload_rejected(pkg, tmp_path):
    ck, _ = pkg
    path = ck.save_checkpoint(str(tmp_path), 1, PAYLOAD)
    target = os.path.join(path, "arr_00000.npy")
    with open(target, "r+b") as f:
        f.truncate(os.path.getsize(target) - 8)
    with pytest.raises(ck.CheckpointError, match="truncated"):
        ck.load_checkpoint(path)


def test_missing_manifest_rejected(pkg, tmp_path):
    ck, _ = pkg
    path = ck.save_checkpoint(str(tmp_path), 1, PAYLOAD)
    os.remove(os.path.join(path, "manifest.json"))
    with pytest.raises(ck.CheckpointError, match="incomplete snapshot"):
        ck.load_checkpoint(path)


def test_latest_skips_invalid(pkg, tmp_path):
    ck, _ = pkg
    p1 = ck.save_checkpoint(str(tmp_path), 1, PAYLOAD)
    p2 = ck.save_checkpoint(str(tmp_path), 2, PAYLOAD)
    with open(os.path.join(p2, "arr_00000.npy"), "r+b") as f:
        f.seek(40)
        f.write(b"\xff\xff")
    assert ck.latest_checkpoint(str(tmp_path)) == p1
    assert ck.latest_checkpoint(str(tmp_path), validate=False) == p2


def test_tmp_debris_invisible_and_pruned(pkg, tmp_path):
    ck, _ = pkg
    ck.save_checkpoint(str(tmp_path), 3, PAYLOAD)
    debris = tmp_path / ".tmp-ckpt-000000000004-999"
    debris.mkdir()
    (debris / "arr_00000.npy").write_bytes(b"partial")
    assert len(ck.list_checkpoints(str(tmp_path))) == 1
    ck.prune_checkpoints(str(tmp_path), 5)
    assert not debris.exists()


def test_retention(pkg, tmp_path):
    ck, _ = pkg
    for i in range(1, 6):
        ck.save_checkpoint(str(tmp_path), i, {"x": np.ones(2)}, keep_last=3)
    tags = [os.path.basename(p) for p in ck.list_checkpoints(str(tmp_path))]
    assert tags == [f"ckpt-{i:012d}" for i in (3, 4, 5)]


def test_object_arrays_rejected(pkg, tmp_path):
    ck, _ = pkg
    with pytest.raises(ck.CheckpointError, match="object array"):
        ck.save_checkpoint(str(tmp_path), 1,
                           {"bad": np.array(["a", None], dtype=object)})


def test_crash_during_save_leaves_no_snapshot(pkg, tmp_path):
    ck, faults = pkg
    with faults.scoped_fault_env("ckpt.save:1"):
        with pytest.raises(faults.FaultInjected):
            ck.save_checkpoint(str(tmp_path), 7, PAYLOAD)
    assert ck.list_checkpoints(str(tmp_path)) == []
    assert ck.latest_checkpoint(str(tmp_path)) is None


# ---------------------------------------------------------------------------
# fault injection (the JAX package's TestFaults, in both packages)
# ---------------------------------------------------------------------------

def test_threshold_and_sites(pkg, monkeypatch):
    _, faults = pkg
    monkeypatch.setenv(faults.FAULT_ENV, "a.b:3; c.d:1")
    faults.maybe_crash("a.b", 2)          # below threshold
    faults.maybe_crash("other", 99)       # unarmed site
    with pytest.raises(faults.FaultInjected) as ei:
        faults.maybe_crash("a.b", 5)      # first call past the threshold
    assert ei.value.site == "a.b" and ei.value.threshold == 3
    with pytest.raises(faults.FaultInjected):
        faults.maybe_crash("c.d", 1)


def test_unset_is_free(pkg, monkeypatch):
    _, faults = pkg
    monkeypatch.delenv(faults.FAULT_ENV, raising=False)
    faults.maybe_crash("comqueue.superstep", 10**9)


@pytest.mark.parametrize("spec,index,outcome", [
    ("s:2-3:error", 2, "transient"), ("s:2-3:error", 4, None),
    ("s:1:corrupt", 1, True), ("s:1:delay:1", 1, False),
    ("s:5", 7, "kill")])
def test_modes_and_windows(pkg, spec, index, outcome):
    """Each mode of the spec grammar, inside and past a bounded window,
    acts the same in both packages (one env var arms both)."""
    _, faults = pkg
    with faults.scoped_fault_env(spec):
        if outcome == "transient":
            with pytest.raises(faults.TransientFault):
                faults.maybe_crash("s", index)
        elif outcome == "kill":
            with pytest.raises(faults.FaultInjected):
                faults.maybe_crash("s", index)
        else:
            assert faults.maybe_crash("s", index) is bool(outcome)
    assert faults.FAULT_ENV not in os.environ


def test_malformed_specs_refused(pkg):
    _, faults = pkg
    for spec in ("nosite", "s:x", "s:3-1", "s:1:explode", "s:1:delay",
                 "s:1;s:2"):
        with faults.scoped_fault_env(spec):
            with pytest.raises(ValueError, match="malformed"):
                faults.maybe_crash("s", 1)


def test_auto_index_counts_visits(pkg):
    """A site without an index counts its visits from 1 once a spec is
    armed; the scope resets the counters on entry and exit."""
    _, faults = pkg
    with faults.scoped_fault_env("v:3"):
        faults.maybe_crash("v")
        faults.maybe_crash("v")
        with pytest.raises(faults.FaultInjected) as ei:
            faults.maybe_crash("v")
        assert ei.value.index == 3
    with faults.scoped_fault_env("v:3"):
        assert faults.maybe_crash("v") is False


# ---------------------------------------------------------------------------
# the format across the two packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch")])
def test_snapshots_interoperate_bitwise(tmp_path, writer, reader):
    """A snapshot written by one package validates and loads bit for bit
    in the other: arrays (with a NaN, a -0.0 and an inf), dtypes, the
    nested structure and the meta; retention and listing agree."""
    wck, rck = PACKAGES[writer][0], PACKAGES[reader][0]
    payload = dict(PAYLOAD)
    payload["edges"] = np.array([np.nan, -0.0, np.inf, 1e-310], np.float64)
    payload["flags"] = np.array([True, False])
    meta = {"signature": {"kind": "demo", "writer": writer}, "step": 4}
    d = str(tmp_path)
    for tag in (2, 4):
        wck.save_checkpoint(d, tag, payload, meta=meta, keep_last=2)
    path = rck.latest_checkpoint(d)
    assert os.path.basename(path) == "ckpt-000000000004"
    assert rck.validate_checkpoint(path)["format"] == "alink_tpu_checkpoint"
    got, got_meta = rck.load_checkpoint(path)
    assert got_meta == meta
    for key in ("z", "edges", "flags"):
        assert got[key].dtype == payload[key].dtype
        assert got[key].tobytes() == payload[key].tobytes()
    assert got["nested"]["ints"].tobytes() == \
        payload["nested"]["ints"].tobytes()
    assert got["mixed"][1] == ("tag", 7, None, 2.5)
    got2, _ = rck.load_latest_validated(d, meta["signature"])
    assert got2["z"].tobytes() == payload["z"].tobytes()
    with pytest.raises(rck.CheckpointError, match="different"):
        rck.load_latest_validated(d, {"kind": "other"})
    assert [os.path.basename(p) for p in rck.list_checkpoints(d)] == \
        ["ckpt-000000000002", "ckpt-000000000004"]


def _cli():
    spec = importlib.util.spec_from_file_location(
        "ckpt_cli", os.path.join(ROOT, "tools", "ckpt.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ckpt_tool_lists_and_validates_port_snapshots(tmp_path, capsys):
    """The JAX package's ``tools/ckpt.py`` on a directory of the port's
    engine snapshots (an L-BFGS run checkpointed every 4 supersteps):
    every snapshot listed as valid, of kind ``comqueue_carry``, its
    progress the superstep; a corrupted one flagged (exit 1); prune."""
    import json
    import torch
    from alink_tpu_torch.common.mlenv import MLEnvironment
    from alink_tpu_torch.operator.common.optim import objfunc as ob
    from alink_tpu_torch.operator.common.optim import optimizers as opt
    r = np.random.RandomState(3)
    X = r.randn(128, 5)
    y = (X @ r.randn(5) > 0).astype(np.float64) * 2 - 1
    d = str(tmp_path / "ck")
    opt.optimize(ob.UnaryLossObjFunc(ob.LogLossFunc(), 5),
                 {"X": X, "y": y, "w": np.ones(128)},
                 opt.OptimParams(method="LBFGS", max_iter=10, epsilon=0.0,
                                 checkpoint_dir=d, checkpoint_every=4),
                 MLEnvironment(device=torch.device("cpu")))
    cli = _cli()
    paths = tck.list_checkpoints(d)
    assert [tck.checkpoint_tag(p) for p in paths] == [4, 8, 10]
    assert cli.main([d, "--validate", "--json"]) == 0
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            if ln]
    assert [r["tag"] for r in recs] == [4, 8, 10]
    for rec in recs:
        assert rec["valid"] is True and rec["kind"] == "comqueue_carry"
        assert rec["progress"] == f"step={rec['tag']}"
        assert rec["arrays"] > 0 and rec["bytes"] > 0
    with open(os.path.join(paths[0], "arr_00000.npy"), "r+b") as f:
        f.seek(40)
        f.write(b"\xff")
    assert cli.main([d, "--validate"]) == 1
    assert "INVALID" in capsys.readouterr().out
    assert cli.main([d, "--prune", "1"]) == 0
    assert len(tck.list_checkpoints(d)) == 1

