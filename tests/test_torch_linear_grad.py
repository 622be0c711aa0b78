"""The ordered sparse gradient of linear training (``kernels/linear.py``)
on the CPU: its plain version, its plan and the margins.

The contract is a Python loop: ``grad[keys[i, k]] += val[i, k] * c[i]``
over the positions in flattened (row, column) order, from ``+0.0``. The
plain version (``index_add_`` on the CPU) is held to that loop bit for
bit, and to the JAX package's padded-COO gradient (an XLA scatter-add)
bit for bit. The kernel itself is held to the plain version on the card
by ``chip_smoke.py`` phase 12. Here also: the plan's classes of runs
(heavy, medium, short) against a numpy reference, the launch's grid, the
kernel's division by the row width, and what reaches the C function.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from alink_tpu_torch.kernels import _build
from alink_tpu_torch.kernels import linear as kl

DTYPES = {"f32": (np.float32, torch.float32), "f64": (np.float64, torch.float64)}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int64) if a.dtype == np.float64 else a.view(np.int32)


def _design(layout, dt, seed=0):
    """Keys, values and c of a small design: padded-COO (an intercept at
    slot 0 in every row, padding at slot 1 with value 0, a few slots left
    unhit) or field-blocked (one key per field, field 0 the intercept)."""
    rng = np.random.RandomState(seed)
    n = 300
    if layout == "coo":
        dim, w = 64, 9
        keys = rng.randint(2, dim - 5, (n, w)).astype(np.int32)
        keys[:, 0] = 0
        val = rng.randn(n, w).astype(dt)
        val[:, 0] = 1.0
        pad = rng.rand(n, w) < 0.2
        pad[:, 0] = False
        keys[pad] = 1
        val[pad] = 0.0
    else:
        F, S = 5, 16
        dim, w = F * S, F
        keys = (rng.randint(0, S, (n, F)) + np.arange(F) * S).astype(np.int32)
        keys[:, 0] = 0
        val = np.ones((n, F), dt)
    c = rng.randn(n).astype(dt)
    c[3] = -0.0
    return keys, val, c, dim


def _heavy_design(dt, seed=0):
    """Runs of every class in one design: slot 0 in every row (the
    intercept, heavy), slots 1 and 2 of equal heavy length, slot 3 exactly
    ``HEAVY_MIN`` long, slot 4 one short of it, slot 5 ``SHORT_MAX + 1``
    long, slot 6 ``SHORT_MAX`` long; the rest short and random."""
    H, S = kl.HEAVY_MIN, kl.SHORT_MAX
    rng = np.random.RandomState(seed)
    n, dim = 2 * H + 600, 4096
    keys = rng.randint(7, dim, (n, 4)).astype(np.int32)
    keys[:, 0] = 0
    rows = np.arange(n)
    keys[rows % 2 == 0, 1] = 1
    keys[rows % 2 == 1, 1] = 2
    keys[:H, 2] = 3
    keys[H:2 * H - 1, 2] = 4
    keys[2 * H:2 * H + S + 1, 3] = 5
    keys[2 * H + S + 1:2 * H + 2 * S + 1, 3] = 6
    val = rng.randn(n, 4).astype(dt)
    c = rng.randn(n).astype(dt)
    return keys, val, c, dim


def _loop(keys, val, c, dim):
    out = np.zeros(dim, val.dtype)
    for i in range(keys.shape[0]):
        for k in range(keys.shape[1]):
            out[keys[i, k]] = out[keys[i, k]] + val[i, k] * c[i]
    return out


@pytest.mark.parametrize("layout", ["coo", "fieldblock", "heavy"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_plain_is_the_sequential_loop(layout, dt):
    npd, tdt = DTYPES[dt]
    keys, val, c, dim = (_heavy_design(npd) if layout == "heavy"
                         else _design(layout, npd))
    plan = kl.grad_plan(torch.from_numpy(keys), dim, torch.from_numpy(val))
    got = kl.linear_grad(plan, torch.from_numpy(c)).numpy()
    assert got.dtype == npd
    np.testing.assert_array_equal(_bits(got), _bits(_loop(keys, val, c, dim)))


def test_plan_runs_intercept_and_unhit_slots():
    """The runs are the distinct keys in key order, each listing its
    positions in ascending order; the intercept's run is every row's
    first position; a slot no key names has no run and a +0.0
    gradient."""
    keys, val, c, dim = _design("coo", np.float64)
    plan = kl.grad_plan(torch.from_numpy(keys), dim, torch.from_numpy(val))
    walk = plan.walk
    starts, perm = walk.starts.numpy(), walk.perm.numpy()
    slots = walk.slots.numpy()[:walk.runs]
    flat = keys.reshape(-1)
    np.testing.assert_array_equal(slots, np.unique(flat))
    assert starts[0] == 0 and starts[walk.runs] == flat.size
    for r, s in enumerate(slots):
        run = perm[starts[r]:starts[r + 1]]
        np.testing.assert_array_equal(run, np.flatnonzero(flat == s))
    n, w = keys.shape
    assert slots[0] == 0
    np.testing.assert_array_equal(perm[starts[0]:starts[1]],
                                  np.arange(n) * w)
    unhit = np.setdiff1d(np.arange(dim), flat)
    assert unhit.size >= 5
    got = kl.linear_grad(plan, torch.from_numpy(c)).numpy()
    assert (_bits(got[unhit]) == 0).all()              # +0.0


@pytest.mark.parametrize("layout", ["coo", "fieldblock", "heavy"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_plan_walk_is_the_plain_bits(layout, dt):
    """The kernel's walk of the shared run plan, in Python: each run from
    +0.0, its positions' rounded products in order, stored at its slot of
    a zeroed vector, gives the plain version's bits."""
    npd, _ = DTYPES[dt]
    keys, val, c, dim = (_heavy_design(npd) if layout == "heavy"
                         else _design(layout, npd))
    plan = kl.grad_plan(torch.from_numpy(keys), dim, torch.from_numpy(val))
    walk = plan.walk
    perm, starts = walk.perm.numpy(), walk.starts.numpy()
    slots, order = walk.slots.numpy(), walk.order.numpy()[:walk.runs]
    assert sorted(order) == list(range(walk.runs))
    width = keys.shape[1]
    fv = val.reshape(-1)
    out = np.zeros(dim, npd)
    for r in order:
        acc = npd(0)
        for p in perm[starts[r]:starts[r + 1]]:
            acc = acc + fv[p] * c[p // width]
        out[slots[r]] = acc
    want = kl.linear_grad(plan, torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(_bits(out), _bits(want))


def _classes(keys):
    """The numpy reference of the plan's run classes, as the runs' slots:
    the runs of more than ``SHORT_MAX`` terms by length, longest first,
    ties by slot, then the short runs by slot; the heavy and medium
    counts."""
    slots, counts = np.unique(keys, return_counts=True)
    order = slots[np.lexsort((slots,
                              np.where(counts > kl.SHORT_MAX, -counts, 0)))]
    n_heavy = int((counts >= kl.HEAVY_MIN).sum())
    n_medium = int(((counts > kl.SHORT_MAX) & (counts < kl.HEAVY_MIN)).sum())
    return order, n_heavy, n_medium


def _class_case(case):
    H, S = kl.HEAVY_MIN, kl.SHORT_MAX
    rng = np.random.RandomState(3)
    if case == "every_class":
        return _heavy_design(np.float64)[0], 4096
    if case == "equal_heavy":       # four heavy runs of one length: by slot
        keys = np.tile(np.array([[9, 2, 30, 5]], np.int32), (H + 3, 1))
        return keys, 40
    if case == "threshold":         # exactly HEAVY_MIN, one short of it
        keys = np.concatenate([np.full(H, 6), np.full(H - 1, 2),
                               np.full(S + 1, 0), np.full(S, 7)])
        return keys.astype(np.int32)[:, None], 8
    if case == "no_heavy":          # the field-blocked bulk: no intercept
        keys = (rng.randint(0, 16, (3000, 5)) + np.arange(5) * 16)
        return keys.astype(np.int32), 80
    keys = np.zeros((H, 2), np.int32)   # dim_below_grid: 3 slots, one run
    return keys, 3


@pytest.mark.parametrize("case", ["every_class", "equal_heavy", "threshold",
                                  "no_heavy", "dim_below_grid"])
def test_plan_classes_runs_by_length(case):
    """``order`` lists the runs of more than ``SHORT_MAX`` terms by length,
    longest first and ties by slot, then the short ones by slot; the first
    ``n_heavy`` have at least ``HEAVY_MIN`` terms, the next ``n_medium``
    more than ``SHORT_MAX``; a run exactly at a threshold takes the longer
    class, one short of it the shorter."""
    keys, dim = _class_case(case)
    walk = kl.grad_plan(torch.from_numpy(keys), dim,
                        torch.ones(keys.shape, dtype=torch.float64)).walk
    order, n_heavy, n_medium = _classes(keys)
    assert walk.order.dtype == walk.slots.dtype == torch.int32
    by_run = walk.order.numpy()[:walk.runs]
    np.testing.assert_array_equal(walk.slots.numpy()[by_run], order)
    assert (walk.n_heavy, walk.n_medium) == (n_heavy, n_medium)
    runs = np.diff(walk.starts.numpy()[:walk.runs + 1])[by_run]
    assert (runs[:n_heavy] >= kl.HEAVY_MIN).all()
    assert (runs[n_heavy:n_heavy + n_medium] > kl.SHORT_MAX).all()
    assert (runs[n_heavy + n_medium:] <= kl.SHORT_MAX).all()
    want = {"every_class": (4, 2), "equal_heavy": (4, 0),
            "threshold": (1, 2), "no_heavy": (0, 80),
            "dim_below_grid": (1, 0)}[case]
    assert (n_heavy, n_medium) == want
    if case == "equal_heavy":
        np.testing.assert_array_equal(order[:4], [2, 5, 9, 30])
    if case == "threshold":
        np.testing.assert_array_equal(order, [6, 2, 0, 7])
    short = by_run[n_heavy + n_medium:]
    assert (np.diff(short) > 0).all()


def _plan_of(runs, n_heavy, n_medium):
    return kl.RunPlan(None, None, None, None, runs, n_heavy, n_medium)


@pytest.mark.parametrize("sms,dim,n_heavy,n_medium,want", [
    (132, 67_584, 1, 65_536, (2, 130)),        # field-blocked: the intercept
    (132, (1 << 20) + 1, 1, 0, (2, 130)),      # padded-COO: short bulk
    (132, 67_584, 0, 65_536, (0, 1056)),       # no intercept: light fills
    (132, 3, 1, 0, (2, 2)),                    # dim below the grid
    (132, 3, 0, 0, (0, 1)),
    (132, 2, 2, 0, (4, 0)),                    # every slot heavy
    (132, 5000, 200, 100, (66, 32)),           # clusters: a quarter of SMs
    (132, 90_000, 200, 8000, (66, 66)),
    (1, 10, 4, 0, (2, 2)),
])
def test_launch_grid(sms, dim, n_heavy, n_medium, want):
    """Heavy blocks: a cluster of two per heavy run, up to a quarter of the
    SMs' clusters; light blocks (8 warps): a warp a medium run or 32
    short runs, up to the SMs the heavy blocks leave (one each, an even
    number) or, with no heavy run, 8 an SM."""
    assert kl.launch_grid(sms, _plan_of(dim, n_heavy, n_medium)) == want


@pytest.mark.parametrize("width", [1, 2, 3, 7, 8, 33, 40, 41, 1000, 2048,
                                   65_537, (1 << 20) + 1, (1 << 30) + 3,
                                   (1 << 31) - 1])
def test_div_magic_is_exact(width):
    """The kernel's row of a position, ``(p * magic) >> shift``, is
    ``p // width`` for every ``p < 2**31`` (edges and a random sample)."""
    magic, shift = kl.div_magic(width)
    assert 0 < magic < 2 ** 32 and 31 <= shift <= 62
    top = 2 ** 31 - 1
    ps = {0, 1, width - 1, width, width + 1, top, top - 1}
    q = top // width
    for k in (1, 2, 3, q - 1, q):
        ps.update({k * width - 1, k * width, k * width + 1})
    rng = np.random.RandomState(width % 1000)
    ps.update(int(x) for x in rng.randint(0, top, 2000))
    for p in ps:
        if 0 <= p <= top:
            assert (p * magic) >> shift == p // width, p


def test_plan_rejects_keys_outside_the_model():
    keys = torch.tensor([[0, 3]], dtype=torch.int32)
    val = torch.ones((1, 2))
    with pytest.raises(IndexError):
        kl.grad_plan(keys, 3, val)
    with pytest.raises(IndexError):
        kl.grad_plan(-keys, 3, val)


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_padded_coo_gradient_is_the_jax_scatter_add(dt):
    """The JAX package's padded-COO gradient (``objfunc.py::rmatvec``, an
    XLA scatter-add) and the plain version agree bit for bit."""
    from alink_tpu.operator.common.optim.objfunc import rmatvec
    npd, _ = DTYPES[dt]
    keys, val, c, dim = _design("coo", npd, seed=4)
    ref = np.asarray(rmatvec({"idx": jnp.asarray(keys), "val": jnp.asarray(val)},
                             jnp.asarray(c), dim))
    plan = kl.grad_plan(torch.from_numpy(keys), dim, torch.from_numpy(val))
    got = kl.linear_grad(plan, torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_margins_are_the_sparse_score_kernels(dt):
    """``sparse_margins`` is the sparse serving kernel's plain version at
    zero bias: each row's terms added left to right from zero."""
    npd, _ = DTYPES[dt]
    keys, val, _, dim = _design("coo", npd, seed=2)
    coef = np.random.RandomState(1).randn(dim).astype(npd)
    got = kl.sparse_margins(torch.from_numpy(keys), torch.from_numpy(val),
                            torch.from_numpy(coef)).numpy()
    want = np.zeros(keys.shape[0], npd)
    for k in range(keys.shape[1]):
        want = want + val[:, k] * coef[keys[:, k]]
    np.testing.assert_array_equal(_bits(got), _bits(want))


class _FakeFn:
    def __init__(self):
        self.calls = []
        self.argtypes = self.restype = None

    def __call__(self, *args):
        self.calls.append(args)
        return 0


def test_cuda_tensors_reach_the_kernel_not_the_plain_version(monkeypatch):
    """With a library in place, a CUDA tensor goes to the C function once,
    on the current stream, and counts one launch; the plain version is
    never called. The plan's tensors reach it by their own pointers (the
    slots' order too), with the division's magic number, the run classes'
    counts and the grid."""
    fake = types.SimpleNamespace(alink_linear_grad=_FakeFn(),
                                 alink_scatter_walk=_FakeFn(),
                                 alink_linear_error_string=_FakeFn())
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
    monkeypatch.setattr(kl, "linear_grad_plain", no_plain)
    kl.reset_launch_counts()
    with FakeTensorMode():
        walk = kl.RunPlan(*(torch.zeros(n, dtype=torch.int32, device="cuda")
                            for n in (40, 41, 40, 40)), 30, 1, 3)
        plan = kl.GradPlan(
            torch.zeros((10, 4), dtype=torch.int32, device="cuda"),
            torch.zeros((10, 4), dtype=torch.float64, device="cuda"), 100,
            walk)
        c = torch.zeros(10, dtype=torch.float64, device="cuda")
        out = kl.linear_grad(plan, c)
        assert out.shape == (100,)
        with pytest.raises(ValueError):
            kl.linear_grad(plan, torch.zeros(10, device="cuda"))
        with pytest.raises(ValueError):
            kl.linear_grad(plan._replace(walk=walk._replace(
                slots=torch.zeros(40, dtype=torch.int32, device="meta"))), c)
    (args,) = fake.alink_linear_grad.calls
    assert args[0] == 1
    assert args[1:8] == tuple(t.data_ptr() for t in (
        walk.perm, walk.starts, walk.order, walk.slots, plan.val, c, out))
    assert len(set(args[1:8])) == 7
    assert args[8:] == (30, *kl.div_magic(4), 1, 3,
                        *kl.launch_grid(132, walk), 55)
    assert kl.launch_grid(132, walk) == (2, 2)
    # the module's other kernel, the ordered scatter-add, launched nothing
    assert kl.launch_counts() == {"linear_grad": 1, "scatter_walk": 0}


def test_margins_route_to_the_sparse_score_kernel(monkeypatch):
    """On the card the margins go to ``serve.sparse_scores`` in f32 mode
    with a zero bias of the values' dtype."""
    seen = []
    monkeypatch.setattr(kl, "sparse_scores",
                        lambda model, idx, val, mode: seen.append(
                            (model, idx, val, mode)) or val[:, 0])
    keys = torch.zeros((3, 2), dtype=torch.int32)
    val = torch.ones((3, 2), dtype=torch.float64)
    kl.sparse_margins(keys, val, torch.ones(4, dtype=torch.float64))
    ((w, b), idx, v, mode) = seen[0]
    assert mode == "f32" and b.dtype == torch.float64 and float(b) == 0.0
    assert idx is keys and v is val
