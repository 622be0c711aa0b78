"""Slice 10 of the port: FTRL's ``update_mode="batch"`` (padded-COO,
field-blocked, dense), the dense strict step, the layouts and the two
drain hooks, held against the JAX package on the CPU.

* The ordered scatter-add's plain version, ``kernels/ftrl.py::
  scatter_add_rows_plain``, on micro-batch-sized inputs against
  ``jnp.ndarray.at[].add``: bitwise, float32 and float64. Its plan
  (``kernels/linear.py::run_plan``) walked as the kernel walks it
  gives the same bits.
* Each step against the JAX package's factory on a 1-device mesh, from
  the same state, in float64: the padded-COO batch step, the dense batch
  step and the dense strict step within rtol 1e-12 per step and 1e-10
  over a stream of micro-batches (not bitwise: XLA's CPU reductions and
  ``exp`` are not torch's). The field-blocked step sums its float32
  deltas in row order where the JAX package's one-hot product sums in
  XLA's order, and its value-less program adds each row's float32
  margin in torch's order: ``z`` and ``n`` within ``FB_RTOL`` of the
  largest delta, the value-less margins within ``FB_RTOL`` of the largest
  margin (measured on these fixtures: at most 5.5e-07 and 8.6e-08; the
  margins with values, float64 sums of float32 selections, agree at
  rtol 1e-12).
* ``FtrlTrainStreamOp(update_mode="batch")`` end to end on padded-COO,
  field-aware hashed and dense (``feature_cols``) streams, a stream whose
  layout demotes from field-blocked to generic partway, and dense rows in
  the strict modes: every snapshot within rtol 1e-10 of the JAX op's, the
  same snapshot times, and the progressive log loss at the pre-batch
  weights. The batch hook's calls and the device snapshot consumer's
  hand-offs equal the JAX op's.

The JAX side runs on an explicit 1-device environment under x64, as the
other port tests run it.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from alink_tpu_torch.common.mtable import MTable as TMTable
from alink_tpu_torch.common.vector import SparseVector as TSparse
from alink_tpu_torch.kernels import ftrl as kf
from alink_tpu_torch.kernels import linear as kl
from alink_tpu_torch.model.interop import model_table_from_reference
from alink_tpu_torch.operator.batch.source import MemSourceBatchOp as TMemB
from alink_tpu_torch.operator.common.linear.base import \
    LinearModelDataConverter as TConverter
from alink_tpu_torch.operator.stream.onlinelearning import ftrl as tf
from alink_tpu_torch.operator.stream.source import MemSourceStreamOp as TMemS
from alink_tpu_torch.ops.fieldblock import FieldBlockMeta as TMeta

HP = (0.05, 1.0, 1e-5, 1e-5)                  # bench_ftrl's alpha, beta, l1, l2
FB_RTOL = 1e-6                                 # the fb step's float32 sums


def _mesh1():
    return Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1), ("d", "m"))


def _jf():
    import alink_tpu.operator.stream.onlinelearning.ftrl as jf
    return jf


def _state(dim, seed=3):
    rng = np.random.RandomState(seed)
    z = rng.randn(dim) * 0.1
    z[5] = -0.0                                # the signed-zero edge
    return z, np.abs(rng.randn(dim)) * 0.1


def _coo(B, dim, width, seed, pad_rows=4):
    """A padded COO micro-batch with the intercept at slot 0 of every real
    row, slots that collide across rows (drawn from a third of the
    state), a row that repeats a slot, and ``pad_rows`` zero rows at the
    bottom (slot 0, value 0)."""
    rng = np.random.RandomState(seed)
    nnz = width - 2
    idx = np.zeros((B, width), np.int32)
    val = np.zeros((B, width))
    real = B - pad_rows
    idx[:real, 1:nnz + 1] = rng.randint(1, dim // 3, size=(real, nnz))
    idx[0, 2] = idx[0, 1]                      # a row that repeats a slot
    val[:real, 0] = 1.0
    val[:real, 1:nnz + 1] = rng.randn(real, nnz)
    y = (rng.rand(B) < 0.5).astype(np.float64)
    y[real:] = 0.0
    return idx, val, y


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---------------------------------------------------------------------------
# the ordered scatter-add: plain version and plan
# ---------------------------------------------------------------------------

SCATTER_SHAPES = {
    # bench_ftrl's batch shapes; its stream's cut to 4096 of 16,384 rows
    "coo": (4096, 40, 65_536 + 1),
    "fb": (4096, 40, 40 * 1648),
    "stream": (4096, 4, 3 * 1648 + 1),
    "one": (1, 1, 7),
    "same_slot": (300, 1, 9),
}


def _scatter_case(name, dtype, seed=0):
    B, w, size = SCATTER_SHAPES[name]
    rng = np.random.RandomState(seed)
    if name == "same_slot":
        keys = np.full((B, w), 4, np.int32)
    else:
        keys = rng.randint(0, size, size=(B, w)).astype(np.int32)
        keys[:, 0] = 0                         # every row's intercept
    terms = rng.randn(B, w, 2).astype(dtype)
    terms[0, 0, 0] = np.nan
    terms[-1, -1, 1] = -0.0
    state = rng.randn(2, size).astype(dtype)
    state[:, size - 1] = -0.0                  # untouched unless drawn
    return keys, terms, state


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", sorted(SCATTER_SHAPES))
def test_scatter_plain_matches_jax_at_add_bitwise(name, dtype):
    import jax.numpy as jnp
    keys, terms, state = _scatter_case(name, dtype)
    want = [np.asarray(jnp.asarray(state[q]).at[keys.reshape(-1)].add(
        jnp.asarray(terms[..., q].reshape(-1)))) for q in range(2)]
    z, n = _torch(state[0].copy(), state[1].copy())
    kl.scatter_walk(z, n, torch.from_numpy(keys), torch.from_numpy(terms))
    for got, w in zip((z.numpy(), n.numpy()), want):
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.view(np.uint8), w.view(np.uint8))


def _walk_plan(plan, state, terms):
    """The kernel's walk of a plan in Python: each run from its stored
    value, its positions in order, one rounded add each (numpy scalars
    of the state's dtype)."""
    perm, starts = plan.perm.numpy(), plan.starts.numpy()
    slots, order = plan.slots.numpy(), plan.order.numpy()
    runs = kl.plan_counts(plan)[0]
    out = state.copy()
    assert sorted(order[:runs]) == list(range(runs))
    for r in order[:runs]:
        for q in range(out.shape[0]):
            acc = out[q, slots[r]]
            for p in perm[starts[r]:starts[r + 1]]:
                acc = acc + terms.reshape(-1, out.shape[0])[p, q]
            out[q, slots[r]] = acc
    return out


@pytest.mark.parametrize("name", ["coo", "stream", "same_slot"])
def test_run_plan_walks_to_the_plain_bits(name, monkeypatch):
    """The plan over the touched slots: runs are the distinct keys in
    key order, lengths and classes as the kernel's grid takes them, and
    its walk gives the plain version's bits. The heavy and medium
    thresholds are scaled down so that the small fixtures have both."""
    monkeypatch.setattr(kl, "HEAVY_MIN", 200)
    monkeypatch.setattr(kl, "SHORT_MAX", 4)
    keys, terms, state = _scatter_case(name, np.float64)
    plan = kl.run_plan(torch.from_numpy(keys), state.shape[1])
    uniq, counts = np.unique(keys, return_counts=True)
    runs, n_heavy, n_medium, n_short = kl.plan_counts(plan)
    assert runs == len(uniq)
    np.testing.assert_array_equal(plan.slots.numpy()[:runs], uniq)
    np.testing.assert_array_equal(np.diff(plan.starts.numpy()[:runs + 1]),
                                  counts)
    assert n_heavy == int((counts >= 200).sum())
    assert n_medium == int(((counts > 4) & (counts < 200)).sum())
    assert n_short == int((counts <= 4).sum())
    lens = counts[plan.order.numpy()[:n_heavy + n_medium]]
    assert list(lens) == sorted(lens, reverse=True)
    z, n = _torch(state[0].copy(), state[1].copy())
    kf.scatter_add_rows_plain(z, torch.from_numpy(keys.reshape(-1)),
                              torch.from_numpy(terms[..., 0].reshape(-1)))
    kf.scatter_add_rows_plain(n, torch.from_numpy(keys.reshape(-1)),
                              torch.from_numpy(terms[..., 1].reshape(-1)))
    walked = _walk_plan(plan, state, terms)
    np.testing.assert_array_equal(walked.view(np.uint8),
                                  np.stack([z.numpy(), n.numpy()])
                                  .view(np.uint8))
    # the CUDA grid of that plan on an H100's 132 SMs, from the positions
    # alone: room for every heavy run the keys could hold
    heavy, light = kl.launch_grid(132, keys.size)
    assert heavy == 2 * min(keys.size // kl.HEAVY_MIN, 33) >= 2 * min(n_heavy, 33)
    assert light >= 1


def test_run_plan_rejects_keys_out_of_range():
    with pytest.raises(IndexError):
        kl.run_plan(torch.tensor([[0, 9]], dtype=torch.int32), 9)
    with pytest.raises(IndexError):
        kl.run_plan(torch.tensor([[-1, 2]], dtype=torch.int32), 9)
    empty = kl.run_plan(torch.zeros((0, 4), dtype=torch.int32), 9)
    assert kl.plan_counts(empty) == (0, 0, 0, 0)
    with pytest.raises(ValueError, match="scatter_walk"):
        kl.scatter_walk(torch.zeros(4), torch.zeros(4),
                        torch.zeros(2, dtype=torch.int64), torch.zeros(2, 2))


def _same_bits_nan_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    nan = np.isnan(a)
    return (nan == np.isnan(b)).all() and \
        (a[~nan].view(np.int32) == b[~nan].view(np.int32)).all()


@pytest.mark.parametrize("B,F,dim,shift", [
    (4096, 40, 40 * 1648, 0),          # bench_ftrl's field-blocked step
    (16_384, 4, 3 * 1648 + 1, 1),      # its stream: the intercept, 3 fields
])
def test_fb_deltas_through_scatter_walk_equal_two_gradients(B, F, dim, shift):
    """The field-blocked step's float32 deltas summed a slot from +0.0:
    one ordered scatter-add of the (dz, dn) pairs into a zeroed (2, dim)
    buffer (what the step does) gives the bits of two gradients with c = 1
    on one plan (what it did): ``v * 1.0`` is ``v``, and an accumulator
    from +0.0 takes a -0.0 term to +0.0 either way. With -0.0, NaN and
    +-inf terms; a NaN equals any NaN, other values their raw bits."""
    rng = np.random.RandomState(B + F)
    keys = (rng.randint(0, 1648, (B, F)) + shift
            + (np.arange(F) - shift) * 1648).astype(np.int32)
    keys[:, 0] = 0                                   # the intercept field
    terms = rng.randn(B, F, 2).astype(np.float32)
    terms[rng.rand(B, F, 2) < 0.02] = -0.0
    terms[7, 2, 0], terms[9, 0, 1] = np.nan, np.nan
    terms[100, 1, 0], terms[101, 1, 0] = np.inf, -np.inf
    terms[B - 1, F - 1, 1] = np.inf
    kt, tt = torch.from_numpy(keys), torch.from_numpy(terms)
    d = torch.zeros((2, dim), dtype=torch.float32)
    kl.scatter_walk(d[0], d[1], kt, tt)
    plan = kl.grad_plan(kt, dim, tt[..., 0].contiguous())
    ones = torch.ones(B, dtype=torch.float32)
    dz = kl.linear_grad_plain(plan, ones)
    dn = kl.linear_grad_plain(plan._replace(val=tt[..., 1].contiguous()), ones)
    assert _same_bits_nan_equal(d[0].numpy(), dz.numpy())
    assert _same_bits_nan_equal(d[1].numpy(), dn.numpy())
    assert np.isnan(d[0].numpy()).any() and np.isinf(d[1].numpy()).any()
    unhit = np.setdiff1d(np.arange(dim), keys)
    assert (d.numpy()[:, unhit].view(np.int32) == 0).all()      # +0.0


class _FakeFn:
    def __init__(self):
        self.calls = []
        self.argtypes = self.restype = None

    def __call__(self, *args):
        self.calls.append(args)
        return 0


def test_cuda_states_reach_the_kernel_not_the_plain_version(monkeypatch):
    """With a library in place, CUDA states go to ``alink_scatter_walk``
    once, z and n in one launch, on the current stream, and count one
    launch; the plain version is never called. The plan's tensors, the
    terms and both states reach it by their own pointers, with the run
    classes' counts and the grid."""
    import types
    from torch._subclasses.fake_tensor import FakeTensorMode
    from alink_tpu_torch.kernels import _build
    fake = types.SimpleNamespace(alink_linear_grad=_FakeFn(),
                                 alink_scatter_walk=_FakeFn(),
                                 alink_linear_error_string=_FakeFn(),
                                 alink_run_plan=_FakeFn(),
                                 alink_run_plan_error_string=_FakeFn())
    monkeypatch.setattr(kl, "_fns", None)
    monkeypatch.setattr(kl, "_sms", {0: 132})
    monkeypatch.setattr(_build, "load_library", lambda n: fake)
    monkeypatch.setattr(_build, "current_device", lambda: 0)
    monkeypatch.setattr(_build, "stream_handle", lambda i: 55)
    ptrs = {}
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda t: ptrs.setdefault(
        id(t), 4096 * (len(ptrs) + 1)))

    def no_plain(*a):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(kl, "scatter_walk_plain", no_plain)
    kl.reset_launch_counts()
    with FakeTensorMode():
        keys = torch.zeros((10, 4), dtype=torch.int32, device="cuda")
        plan = kl.RunPlan(*(torch.zeros(n, dtype=torch.int32, device="cuda")
                            for n in (40, 41, 40, 40, 4)))
        z = torch.zeros(100, dtype=torch.float64, device="cuda")
        n = torch.zeros(100, dtype=torch.float64, device="cuda")
        terms = torch.zeros((10, 4, 2), dtype=torch.float64, device="cuda")
        kl.scatter_walk(z, n, keys, terms, plan=plan)
        with pytest.raises(ValueError):
            kl.scatter_walk(z, n, keys, torch.zeros(
                (10, 4, 2), dtype=torch.float32, device="cuda"), plan=plan)
        with pytest.raises(ValueError):            # another set of keys'
            kl.scatter_walk(z, n, torch.zeros(
                (5, 4), dtype=torch.int32, device="cuda"), torch.zeros(
                (5, 4, 2), dtype=torch.float64, device="cuda"), plan=plan)
    (args,) = fake.alink_scatter_walk.calls
    assert args[:2] == (0, 1)
    assert args[2:10] == tuple(t.data_ptr() for t in (
        plan.perm, plan.starts, plan.order, plan.slots, plan.counts, terms,
        z, n))
    assert len(set(args[2:10])) == 8
    assert args[10:] == (*kl.launch_grid(132, 40), 55)
    assert not fake.alink_linear_grad.calls
    assert kl.launch_counts() == {"linear_grad": 0, "scatter_walk": 1,
                                  "run_plan": 0}


def test_cuda_keys_reach_the_plan_kernel_with_no_host_read(monkeypatch):
    """On the card the plan is one call of ``alink_run_plan`` (its grid
    from ``plan_grid`` at the card's SMs, its sort's digits from
    ``sort_digits``) into one int32 buffer: the plan's arrays are views of
    it at the kernel's offsets (perm, starts, slots, order, counts), the
    kernel's scratch after them; nothing reads the host (FakeTensorMode
    raises on a read of a fake tensor's data). Keys that are not int32
    raise."""
    import types
    from torch._subclasses.fake_tensor import FakeTensorMode
    from alink_tpu_torch.kernels import _build
    fake = types.SimpleNamespace(alink_linear_grad=_FakeFn(),
                                 alink_scatter_walk=_FakeFn(),
                                 alink_linear_error_string=_FakeFn(),
                                 alink_run_plan=_FakeFn(),
                                 alink_run_plan_error_string=_FakeFn())
    monkeypatch.setattr(kl, "_fns", None)
    monkeypatch.setattr(kl, "_sms", {0: 132})
    monkeypatch.setattr(_build, "load_library", lambda n: fake)
    monkeypatch.setattr(_build, "current_device", lambda: 0)
    monkeypatch.setattr(_build, "stream_handle", lambda i: 55)
    ptrs = {}
    monkeypatch.setattr(torch.Tensor, "data_ptr", lambda t: ptrs.setdefault(
        id(t), 4096 * (len(ptrs) + 1)))

    def no_plain(*a):
        raise AssertionError("CUDA keys reached the plain plan")
    monkeypatch.setattr(kl, "run_plan_plain", no_plain)
    kl.reset_launch_counts()
    with FakeTensorMode():
        keys = torch.zeros((4096, 40), dtype=torch.int32, device="cuda")
        plan = kl.run_plan(keys, 65_537)
        with pytest.raises(ValueError):
            kl.run_plan(keys.long(), 65_537)
        base = plan.perm._base
        assert all(t._base is base for t in plan)
        offsets = [t.storage_offset() for t in (
            plan.perm, plan.starts, plan.slots, plan.order, plan.counts)]
    M = 4096 * 40
    (args,) = fake.alink_run_plan.calls
    chunk, blocks = kl.plan_grid(M, 132)
    assert (chunk, blocks) == (4096, 40)
    assert args[1:7] == (M, 65_537, chunk, blocks, *kl.sort_digits(65_537))
    assert [t.shape[0] for t in plan] == [M, M + 1, M, M, 4]
    assert offsets == [0, M, 2 * M + 1, 3 * M + 1, 4 * M + 1]
    assert args[7] == base.data_ptr() != args[0]          # keys, buffer
    # the scratch: the sorted keys, the long runs and their lengths, the
    # histogram, the digit totals and five values a block
    assert args[8] == base.numel() == (4 * M + 5 + M + 2 * (M // 33 + 1)
                                       + (2 ** 9 + 5) * blocks + 2 ** 9)
    assert args[9] == 55
    assert kl.launch_counts() == {"linear_grad": 0, "scatter_walk": 0,
                                  "run_plan": 1}


# ---------------------------------------------------------------------------
# the steps against the JAX package's factories
# ---------------------------------------------------------------------------

def _check(got, want, rtol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol,
                                   atol=1e-14)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_coo_batch_step_matches_jax(seed):
    """62 rows (4 of them padding) of 16 slots over a 512-slot state with
    a -0.0: collisions inside the batch, a row that repeats a slot, the
    intercept in every real row."""
    dim = 512
    idx, val, y = _coo(62, dim, 16, seed)
    z0, n0 = _state(dim)
    jstep = _jf()._ftrl_sparse_batch_step_factory(_mesh1(), *HP)
    want = jstep(idx, val, y, z0, n0)
    z, n = _torch(z0.copy(), n0.copy())
    got = tf.ftrl_batch_step(*_torch(idx, val, y), z, n, *HP)
    assert got[2].shape == (62,)
    _check([t.numpy() for t in got], want, 1e-12)


def test_coo_batch_stream_matches_jax():
    """Eight micro-batches in turn from one state: rtol 1e-10."""
    dim = 512
    jstep = _jf()._ftrl_sparse_batch_step_factory(_mesh1(), *HP)
    zj, nj = _state(dim)
    z, n = _torch(zj.copy(), nj.copy())
    for b in range(8):
        idx, val, y = _coo(48, dim, 16, 100 + b)
        zj, nj, mj = jstep(idx, val, y, zj, nj)
        z, n, m = tf.ftrl_batch_step(*_torch(idx, val, y), z, n, *HP)
        _check([m.numpy()], [mj], 1e-10)
    _check([z.numpy(), n.numpy()], [zj, nj], 1e-10)


def _fb_case(B, F, S, seed, with_val):
    rng = np.random.RandomState(seed)
    fbi = rng.randint(0, S, size=(B, F)).astype(np.int32)
    fbi[:, 0] = 0                              # the intercept field
    fbv = (np.ones((B, F)) if not with_val
           else np.round(rng.rand(B, F) * 4, 1))
    fbv[:, 0] = 1.0
    y = (rng.rand(B) < 0.5).astype(np.float64)
    return fbi, fbv, y


def _fb_gap(got, want, terms):
    """The largest gap of the states over the largest delta at a slot."""
    return float(np.max(np.abs(got - want)) / np.max(np.abs(terms)))


@pytest.mark.parametrize("with_val", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_fb_batch_step_matches_jax(seed, with_val):
    """256 rows over 5 fields of 32 (the intercept field first), values or
    none, int16 indices: the margins and the state within the module's
    tolerances (float32 sums in another order)."""
    B, F, S = 256, 5, 32
    meta = TMeta(F, S)
    fbi, fbv, y = _fb_case(B, F, S, seed, with_val)
    z0, n0 = _state(F * S, seed=seed + 4)
    from alink_tpu.ops.fieldblock import FieldBlockMeta
    jstep = _jf()._ftrl_fb_batch_step_factory(
        _mesh1(), FieldBlockMeta(F, S), *HP, with_val=with_val)
    want = (jstep(fbi, fbv, y, z0, n0) if with_val
            else jstep(fbi, y, z0, n0))
    z, n = _torch(z0.copy(), n0.copy())
    tfbi = torch.from_numpy(fbi.astype(np.int16))
    got = tf.ftrl_fb_batch_step(tfbi, torch.from_numpy(fbv) if with_val
                                else None, torch.from_numpy(y), z, n, meta,
                                *HP)
    mg, mw = got[2].numpy(), np.asarray(want[2])
    assert mg.dtype == mw.dtype == (np.float64 if with_val else np.float32)
    if with_val:
        np.testing.assert_allclose(mg, mw, rtol=1e-12, atol=0)
    else:
        assert np.max(np.abs(mg - mw)) / np.max(np.abs(mw)) < FB_RTOL
    dz, dn = (np.asarray(w) - s for w, s in zip(want[:2], (z0, n0)))
    for g, w, d in zip(got[:2], want[:2], (dz, dn)):
        assert _fb_gap(g.numpy(), np.asarray(w), d) < FB_RTOL


def test_fb_gather_is_an_exact_float32_selection():
    from alink_tpu.ops.fieldblock import FieldBlockMeta, fb_gather
    from alink_tpu_torch.ops.fieldblock import fb_gather as t_fb_gather
    rng = np.random.RandomState(0)
    fbi = rng.randint(0, 32, size=(64, 6)).astype(np.int32)
    vec = rng.randn(6 * 32)
    want = np.asarray(fb_gather(fbi, vec, FieldBlockMeta(6, 32)))
    got = t_fb_gather(torch.from_numpy(fbi), torch.from_numpy(vec),
                      TMeta(6, 32))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    pair = t_fb_gather(torch.from_numpy(fbi), torch.from_numpy(vec),
                       TMeta(6, 32), other=torch.from_numpy(-vec))
    np.testing.assert_array_equal(pair[..., 0].numpy(), want)
    np.testing.assert_array_equal(pair[..., 1].numpy(), -want)


def _dense(B, D, seed):
    rng = np.random.RandomState(seed)
    X = rng.randn(B, D)
    X[:, 0] = 1.0
    X[-3:] = 0.0                               # padding rows
    y = (rng.rand(B) < 0.5).astype(np.float64)
    y[-3:] = 0.0
    return X, y


@pytest.mark.parametrize("kind", ["batch", "strict"])
def test_dense_steps_match_jax(kind):
    """The dense batch and strict steps, 40 rows of 24 over three
    micro-batches: rtol 1e-12 after the first, 1e-10 after the stream."""
    jf = _jf()
    if kind == "batch":
        jstep = jf._ftrl_dense_batch_step_factory(_mesh1(), *HP)
        tstep = tf.ftrl_dense_batch_step
    else:
        jstep = jf._ftrl_step_factory(_mesh1(), *HP)[0]
        tstep = tf.ftrl_dense_step
    zj, nj = _state(24)
    z, n = _torch(zj.copy(), nj.copy())
    for b in range(3):
        X, y = _dense(40, 24, b)
        zj, nj, mj = jstep(X, y, zj, nj)
        z, n, m = tstep(*_torch(X, y), z, n, *HP)
        _check([z.numpy(), n.numpy(), m.numpy()], [zj, nj, mj],
               1e-12 if b == 0 else 1e-10)


# ---------------------------------------------------------------------------
# FtrlTrainStreamOp end to end against the JAX package's op
# ---------------------------------------------------------------------------

STREAM_HP = dict(alpha=0.05, beta=1.0, l1=1e-5, l2=1e-5)
N_ROWS, DIM, NNZ = 150, 200, 9


def _sparse_rows(seed=7):
    rng = np.random.RandomState(seed)
    wtrue = rng.randn(DIM) * (rng.rand(DIM) < 0.3)
    idx = [np.sort(rng.choice(DIM, NNZ, False)) for _ in range(N_ROWS)]
    val = [rng.randn(NNZ) for _ in range(N_ROWS)]
    y = np.asarray([int(v @ wtrue[i] + 0.1 * rng.randn() > 0)
                    for i, v in zip(idx, val)])
    return idx, val, y


def _fb_rows(seed=11, n=650):
    """Three categorical columns hashed field-aware into 3 fields of 16;
    clicks depend on the site's parity."""
    rng = np.random.RandomState(seed)
    site = rng.randint(0, 60, n)
    cols = {"site": np.char.add("s", site.astype("U3")).astype(object),
            "dev": np.char.add("d", rng.randint(0, 60, n).astype("U3"))
            .astype(object),
            "app": np.char.add("a", rng.randint(0, 60, n).astype("U3"))
            .astype(object),
            "click": (rng.rand(n) < 0.2 + 0.6 * (site % 2)).astype(np.int64)}
    return cols, "site STRING, dev STRING, app STRING, click LONG"


def _dense_rows(seed=5, n=130, d=6):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d)
    y = (X @ rng.randn(d) + 0.3 * rng.randn(n) > 0).astype(np.int64)
    cols = {f"f{j}": X[:, j] for j in range(d)}
    cols["label"] = y
    schema = ", ".join(f"f{j} DOUBLE" for j in range(d)) + ", label LONG"
    return cols, schema, [f"f{j}" for j in range(d)]


HASH_KW = dict(selected_cols=["site", "dev", "app"],
               categorical_cols=["site", "dev", "app"], output_col="vec",
               num_features=48, field_aware=True)


def _tables(kind):
    """(jax table, port table, schema-free label col, train kwargs)."""
    from alink_tpu.common.mtable import MTable
    from alink_tpu.common.vector import SparseVector
    if kind == "coo":
        idx, val, y = _sparse_rows()
        jv, tv = np.empty(N_ROWS, object), np.empty(N_ROWS, object)
        jv[:] = [SparseVector(DIM, i, v) for i, v in zip(idx, val)]
        tv[:] = [TSparse(DIM, i, v) for i, v in zip(idx, val)]
        sch = "vec VECTOR, label LONG"
        return (MTable({"vec": jv, "label": y}, sch),
                TMTable({"vec": tv, "label": y}, sch),
                dict(vector_col="vec", label_col="label"))
    if kind == "fb":
        cols, sch = _fb_rows()
        return (MTable(dict(cols), sch), TMTable(dict(cols), sch),
                dict(vector_col="vec", label_col="click"))
    if kind == "demote":
        # 3 fields of 16: rows one-hot in each field, then, from row 120
        # on, rows with a second slot in field 0 (no longer field-blocked)
        rng = np.random.RandomState(13)
        n, jv, tv = 240, np.empty(240, object), np.empty(240, object)
        y = rng.randint(0, 2, n)
        for i in range(n):
            ix = np.arange(3) * 16 + rng.randint(0, 16, 3)
            if i >= 120:
                ix = np.sort(np.append(ix, (ix[0] + 1) % 16))
            v = np.ones(len(ix)) if i % 7 else rng.rand(len(ix)) + 0.5
            jv[i] = SparseVector(48, ix, v)
            tv[i] = TSparse(48, ix, v)
        sch = "vec VECTOR, label LONG"
        return (MTable({"vec": jv, "label": y}, sch),
                TMTable({"vec": tv, "label": y}, sch),
                dict(vector_col="vec", label_col="label"))
    cols, sch, fcols = _dense_rows()
    return (MTable(dict(cols), sch), TMTable(dict(cols), sch),
            dict(feature_cols=fcols, label_col="label"))


@pytest.fixture(scope="module")
def jax_env():
    from alink_tpu.common.mlenv import MLEnvironment, MLEnvironmentFactory
    sid = MLEnvironmentFactory.register(
        MLEnvironment(parallelism=1, devices=jax.devices()[:1]))
    yield sid
    MLEnvironmentFactory.remove(sid)


_WARM = {}


def _warm(kind, sid):
    """The JAX package's LR warm start on the first rows of ``kind``'s
    table (hashed field-aware for ``"fb"``), and the port's copy."""
    if kind in _WARM:
        return _WARM[kind]
    from alink_tpu.operator.batch.classification.linear import (
        LogisticRegressionTrainBatchOp)
    from alink_tpu.operator.batch.feature.feature_ops import (
        FeatureHasherBatchOp)
    from alink_tpu.operator.batch.source.sources import MemSourceBatchOp
    jt, _, kw = _tables(kind)
    src = MemSourceBatchOp(jt.first_n(60), ml_environment_id=sid)
    if kind == "fb":
        src = FeatureHasherBatchOp(ml_environment_id=sid,
                                   **HASH_KW).link_from(src)
    warm = LogisticRegressionTrainBatchOp(
        max_iter=3, ml_environment_id=sid, **kw).link_from(src)
    wt = warm.get_output_table()
    _WARM[kind] = (warm, TMemB(model_table_from_reference(
        wt.to_rows(), wt.schema.types[2])))
    return _WARM[kind]


def _stream_ops(kind, sid, batch_size, jax_kw=None, **op_kw):
    """The JAX op (with ``jax_kw`` too) and the port's op on ``kind``'s
    stream, and their sources, not yet linked."""
    from alink_tpu.operator.stream.batch_twins import FeatureHasherStreamOp
    from alink_tpu.operator.stream.onlinelearning.ftrl import (
        FtrlTrainStreamOp)
    from alink_tpu.operator.stream.source.sources import MemSourceStreamOp
    from alink_tpu_torch.operator.stream.batch_twins import \
        FeatureHasherStreamOp as THasherS
    jt, tt, kw = _tables(kind)
    jwarm, twarm = _warm(kind, sid)
    jsrc = MemSourceStreamOp(jt, batch_size=batch_size,
                             ml_environment_id=sid)
    tsrc = TMemS(tt, batch_size=batch_size)
    if kind == "fb":
        jsrc = FeatureHasherStreamOp(ml_environment_id=sid,
                                     **HASH_KW).link_from(jsrc)
        tsrc = THasherS(**HASH_KW).link_from(tsrc)
    kw = dict(kw, **STREAM_HP, time_interval=2.0, **op_kw)
    jop = FtrlTrainStreamOp(jwarm, ml_environment_id=sid, **kw,
                            **(jax_kw or {}))
    top = tf.FtrlTrainStreamOp(twarm, device="cpu", ship_dtype=torch.float64,
                               **kw)
    return jop, top, jsrc, tsrc


def _snaps(op, table_cls):
    return [(t, table_cls.load_table(s).coef) for t, s in op.timed_batches()]


def _compare_snapshots(jop, top, rtol=1e-10):
    from alink_tpu.operator.common.linear.base import LinearModelDataConverter
    js, ts = _snaps(jop, LinearModelDataConverter), _snaps(top, TConverter)
    assert [t for t, _ in ts] == [t for t, _ in js] and len(js) >= 3
    for (_, got), (_, want) in zip(ts, js):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-14)
    return ts


def _monitor():
    from alink_tpu.common.health import HealthMonitor
    return HealthMonitor(rules=[])


def _compare_progressive(mon, top, rtol=1e-10):
    steps, vals = mon.series("ftrl.pv_logloss")
    pl = top.progressive_logloss()
    assert [b for b, _ in pl] == list(steps)
    np.testing.assert_allclose([v for _, v in pl], vals, rtol=rtol)


@pytest.mark.parametrize("kind,batch_size", [("coo", 32), ("fb", 100),
                                             ("dense", 25)])
def test_batch_mode_stream_matches_jax(jax_env, kind, batch_size,
                                      monkeypatch):
    """``update_mode="batch"`` on padded-COO rows, field-aware hashed rows
    (the field-blocked program: full micro-batches without values, the
    partial last one with them) and dense ``feature_cols``: the same
    snapshot times; every snapshot and the progressive log loss of every
    micro-batch (the JAX op's monitor's) within rtol 1e-10, ``FB_RTOL``
    on the field-blocked stream (measured: at most 1.2e-07 on its
    coefficients)."""
    fb_calls = _spy_fb(monkeypatch)
    mon = _monitor()
    jop, top, jsrc, tsrc = _stream_ops(kind, jax_env, batch_size,
                                       jax_kw={"health": mon},
                                       update_mode="batch")
    jop.link_from(jsrc)
    top.link_from(tsrc)
    rtol = FB_RTOL if kind == "fb" else 1e-10
    _compare_snapshots(jop, top, rtol)
    _compare_progressive(mon, top, rtol)
    # the field-blocked program ran every micro-batch of the hashed
    # stream: the full ones without values, the partial last one with
    want = [False] * 6 + [True] if kind == "fb" else []
    assert fb_calls == want


def _spy_fb(monkeypatch):
    """Record each field-blocked step's ``val is not None``."""
    calls = []
    step = tf.ftrl_fb_batch_step

    def spy(fb_idx, val, *a):
        calls.append(val is not None)
        return step(fb_idx, val, *a)
    monkeypatch.setattr(tf, "ftrl_fb_batch_step", spy)
    return calls


def test_fb_layout_demotes_exactly(jax_env, monkeypatch):
    """A stream whose first micro-batches are field-blocked and whose
    later ones are not: the state moves to the generic layout exactly at
    the first micro-batch that is not (after three field-blocked ones),
    and every snapshot and progressive log loss stays within ``FB_RTOL``
    of the JAX op's."""
    fb_calls = _spy_fb(monkeypatch)
    mon = _monitor()
    jop, top, jsrc, tsrc = _stream_ops("demote", jax_env, 40,
                                       jax_kw={"health": mon},
                                       update_mode="batch")
    jop.link_from(jsrc)
    top.link_from(tsrc)
    _compare_snapshots(jop, top, FB_RTOL)
    _compare_progressive(mon, top, FB_RTOL)
    assert fb_calls == [True] * 3


def test_demotion_is_an_exact_translation(jax_env):
    """``to_std_state`` against the JAX op's ``fb_to_std_state``
    layout: the intercept at slot 0 and the features after the unused
    slots of the intercept field, bitwise; and the fb snapshot maps the
    same coefficients."""
    _, twarm = _warm("demote", jax_env)
    top = tf.FtrlTrainStreamOp(twarm, device="cpu", ship_dtype=torch.float64,
                               vector_col="vec", label_col="label",
                               update_mode="batch", **STREAM_HP)
    top.link_from(TMemS(_tables("demote")[1]))
    tr = top.trainer
    meta = TMeta(4, 16)
    z = torch.arange(tr.fb_size(meta), dtype=torch.float64)
    n = z * 0.5
    zs, ns = tr.to_std_state(z, n, 16)
    want = np.concatenate([[0.0], np.arange(16, 16 + 48)])
    np.testing.assert_array_equal(zs.numpy(), want)
    np.testing.assert_array_equal(ns.numpy(), want * 0.5)
    a = TConverter.load_table(tr.snapshot(z, n, 16)).coef
    b = TConverter.load_table(tr.snapshot(zs, ns)).coef
    np.testing.assert_array_equal(a, b)
    z0, _ = tr.initial_state(tr.encode(_fb_table(), 4, allow_fb=True))
    zs0, _ = tr.initial_state()
    np.testing.assert_array_equal(tr.to_std_state(z0, z0, 16)[0].numpy(),
                                  zs0.numpy())


def _fb_table():
    """Four field-blocked rows of the demotion stream's layout."""
    vecs = np.empty(4, object)
    vecs[:] = [TSparse(48, np.arange(3) * 16 + i, np.ones(3))
               for i in range(4)]
    return TMTable({"vec": vecs, "label": np.arange(4) % 2},
                   "vec VECTOR, label LONG")


def test_encode_ships_int16_and_drops_values_of_one_hot_batches(jax_env):
    """The field-blocked encoding: int16 indices (a field of 16 fits), the
    intercept field first; a full micro-batch of one-hot rows ships no
    value block, a partial one ships values with zero padding rows."""
    _, twarm = _warm("demote", jax_env)
    top = tf.FtrlTrainStreamOp(twarm, device="cpu", ship_dtype=torch.float64,
                               vector_col="vec", label_col="label",
                               update_mode="batch", **STREAM_HP)
    top.link_from(TMemS(_tables("demote")[1]))
    tr = top.trainer
    full = tr.encode(_fb_table(), 4, allow_fb=True)
    assert full.kind == "fb" and full.meta == TMeta(4, 16)
    fbi, fbv, y = full.arrays
    assert fbi.dtype == np.int16 and fbv is None
    np.testing.assert_array_equal(fbi[:, 0], 0)
    np.testing.assert_array_equal(fbi[:, 1:], np.arange(4)[:, None]
                                  * np.ones(3, np.int16))
    part = tr.encode(_fb_table(), 6, allow_fb=True)
    fbi, fbv, y = part.arrays
    assert fbv.dtype == np.float64 and fbv.shape == (6, 4)
    np.testing.assert_array_equal(fbv[:4], 1.0)
    np.testing.assert_array_equal(fbv[4:], 0.0)
    assert tr.encode(_fb_table(), 4).kind == "sparse"


@pytest.mark.parametrize("mode", ["sample", "staleness", "chained"])
def test_dense_rows_in_strict_modes_match_jax(jax_env, mode):
    """Dense rows outside batch mode take the strict dense step in every
    mode, as in the JAX op: snapshots within rtol 1e-10."""
    jop, top, jsrc, tsrc = _stream_ops("dense", jax_env, 25,
                                       update_mode=mode, staleness=8,
                                       chunk_size=8)
    jop.link_from(jsrc)
    top.link_from(tsrc)
    _compare_snapshots(jop, top)


def _recorder():
    calls = []
    return calls, lambda *a: calls.append(a)


@pytest.mark.parametrize("kind", ["coo", "fb"])
def test_batch_hook_calls_match_jax(jax_env, kind):
    """``set_batch_hook``: ``("pre", b, t)`` before batch b's update and
    ``("post", b, t)`` after it has committed, in the JAX op's order and
    interleaved with the snapshots as the JAX op interleaves them."""
    logs = []
    for side in (0, 1):
        jop, top, jsrc, tsrc = _stream_ops(kind, jax_env, 50,
                                           update_mode="batch")
        op = (jop, top)[side].link_from((jsrc, tsrc)[side])
        calls, hook = _recorder()
        op.set_batch_hook(hook)
        for t, _ in op.timed_batches():
            calls.append(("snapshot", t))
        logs.append(calls)
    assert logs[1] == logs[0]
    assert logs[0][0] == ("pre", 1, 0.0) and logs[0][1] == ("post", 1, 0.0)


def test_device_snapshot_consumer_matches_jax(jax_env):
    """``set_device_snapshot_consumer``: handed the live device weights
    and the same info at every emission boundary; a boundary whose
    consumer returns True yields no host snapshot (here the even ones),
    the others the same snapshots as the JAX op's."""
    got = []
    for side in (0, 1):
        jop, top, jsrc, tsrc = _stream_ops("fb", jax_env, 100,
                                           update_mode="batch")
        op = (jop, top)[side].link_from((jsrc, tsrc)[side])
        seen = []

        def hook(w, info, seen=seen):
            seen.append((np.asarray(w), dict(info)))
            return len(seen) % 2 == 0
        op.set_device_snapshot_consumer(hook)
        snaps = [(t, np.asarray(s.col("model_info")[1:]))
                 for t, s in op.timed_batches()]
        got.append((seen, snaps))
    (jseen, jsnaps), (tseen, tsnaps) = got
    assert [i for _, i in tseen] == [i for _, i in jseen]
    assert tseen[0][1]["fb_S"] == 16 and len(tseen) == 4
    for (tw, _), (jw, _) in zip(tseen, jseen):
        assert tw.shape == jw.shape
        np.testing.assert_allclose(tw, jw, rtol=FB_RTOL, atol=1e-14)
    assert [t for t, _ in tsnaps] == [t for t, _ in jsnaps] == [2.0, 6.0]
