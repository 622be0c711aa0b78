"""The ordered sparse gradient of linear training (``kernels/linear.py``)
on the CPU: its plain version, its plan and the margins.

The contract is a Python loop: ``grad[keys[i, k]] += val[i, k] * c[i]``
over the positions in flattened (row, column) order, from ``+0.0``. The
plain version (``index_add_`` on the CPU) is held to that loop bit for
bit, and to the JAX package's padded-COO gradient (an XLA scatter-add)
bit for bit. The kernel itself is held to the plain version on the card
by ``chip_smoke.py`` phase 12.
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


def _loop(keys, val, c, dim):
    out = np.zeros(dim, val.dtype)
    for i in range(keys.shape[0]):
        for k in range(keys.shape[1]):
            out[keys[i, k]] = out[keys[i, k]] + val[i, k] * c[i]
    return out


@pytest.mark.parametrize("layout", ["coo", "fieldblock"])
@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_plain_is_the_sequential_loop(layout, dt):
    npd, tdt = DTYPES[dt]
    keys, val, c, dim = _design(layout, npd)
    plan = kl.grad_plan(torch.from_numpy(keys), dim, torch.from_numpy(val))
    got = kl.linear_grad(plan, torch.from_numpy(c)).numpy()
    assert got.dtype == npd
    np.testing.assert_array_equal(_bits(got), _bits(_loop(keys, val, c, dim)))


def test_plan_runs_intercept_and_unhit_slots():
    """Each slot's run lists its positions in ascending order; the
    intercept's run is every row's first position; a slot no key names
    has an empty run and a +0.0 gradient."""
    keys, val, c, dim = _design("coo", np.float64)
    plan = kl.grad_plan(torch.from_numpy(keys), dim, torch.from_numpy(val))
    starts, perm = plan.starts.numpy(), plan.perm.numpy()
    flat = keys.reshape(-1)
    assert starts[0] == 0 and starts[-1] == flat.size
    for s in range(dim):
        run = perm[starts[s]:starts[s + 1]]
        np.testing.assert_array_equal(run, np.flatnonzero(flat == s))
    n, w = keys.shape
    np.testing.assert_array_equal(perm[starts[0]:starts[1]],
                                  np.arange(n) * w)
    unhit = np.setdiff1d(np.arange(dim), flat)
    assert unhit.size >= 5
    assert (starts[unhit + 1] == starts[unhit]).all()
    got = kl.linear_grad(plan, torch.from_numpy(c)).numpy()
    assert (_bits(got[unhit]) == 0).all()              # +0.0


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
    never called."""
    fake = types.SimpleNamespace(alink_linear_grad=_FakeFn(),
                                 alink_linear_error_string=_FakeFn())
    monkeypatch.setattr(kl, "_fns", None)
    monkeypatch.setattr(kl, "_grids", {0: 1056})
    monkeypatch.setattr(_build, "load_library", lambda n: fake)
    monkeypatch.setattr(_build, "current_device", lambda: 0)
    monkeypatch.setattr(_build, "stream_handle", lambda i: 55)

    def no_plain(*a):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(kl, "linear_grad_plain", no_plain)
    kl.reset_launch_counts()
    with FakeTensorMode():
        plan = kl.GradPlan(
            torch.zeros((10, 4), dtype=torch.int32, device="cuda"),
            torch.zeros((10, 4), dtype=torch.float64, device="cuda"),
            torch.zeros(40, dtype=torch.int32, device="cuda"),
            torch.zeros(101, dtype=torch.int32, device="cuda"), 100)
        kl.linear_grad(plan, torch.zeros(10, dtype=torch.float64,
                                         device="cuda"))
        with pytest.raises(ValueError):
            kl.linear_grad(plan, torch.zeros(10, device="cuda"))
    (args,) = fake.alink_linear_grad.calls
    assert args[0] == 1 and args[6:] == (100, 4, 13, 55)
    assert kl.launch_counts() == {"linear_grad": 1}


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
