"""The port's level-histogram kernel on the CPU: its plain version against
the JAX package's histograms, and no fallback off the CPU.

``level_hist`` (``alink_tpu_torch/kernels/tree_hist.py``) runs its plain
version for CPU tensors. That version is held bit for bit against the
JAX package's CPU default, ``level_hist(..., use_onehot=False)`` (an XLA
scatter-add, which sums each slot in ascending row order), and within
the recursive-summation bound of the Pallas kernel ``_pallas_level_hist``
run directly (interpret mode on the CPU), whose one-hot matrix product
sums in another order. The CUDA kernel itself is held to the plain
version bit for bit on the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from alink_tpu.operator.common.tree.hist import (_pallas_level_hist,
                                                 level_hist as jax_level_hist)
from alink_tpu_torch.kernels import _build
from alink_tpu_torch.kernels import tree_hist as kh

N_ROWS = 1037            # a multiple of no chunk or block size
F = 5


def _inputs(n_nodes, n_bins, m, n=N_ROWS, seed=0):
    rng = np.random.RandomState(seed + 97 * n_nodes + 7 * n_bins + m)
    binned = rng.randint(0, n_bins, (n, F)).astype(np.int32)
    stats = (rng.randn(n, m) * rng.uniform(0.1, 10.0, (n, 1))).astype(
        np.float32)
    stats[rng.rand(n) < 0.1] = 0.0                   # bagged-out rows
    node_id = rng.randint(0, n_nodes, n).astype(np.int32)
    return binned, stats, node_id


def _plain(binned, stats, node_id, n_nodes, n_bins):
    return kh.level_hist(torch.from_numpy(binned), torch.from_numpy(stats),
                         torch.from_numpy(node_id), n_nodes,
                         n_bins).numpy()


def _bits(a):
    return np.asarray(a).view(np.int32)


CASES = [(n_nodes, n_bins, m) for n_nodes in (1, 2, 8, 32)
         for n_bins in (2, 16, 64) for m in (3, 4)]


@pytest.mark.parametrize("n_nodes,n_bins,m", CASES)
def test_plain_bitwise_vs_jax_default(n_nodes, n_bins, m):
    binned, stats, node_id = _inputs(n_nodes, n_bins, m)
    ref = jax_level_hist(jnp.asarray(binned), jnp.asarray(stats),
                         jnp.asarray(node_id), n_nodes, n_bins,
                         use_onehot=False)
    got = _plain(binned, stats, node_id, n_nodes, n_bins)
    assert got.shape == (n_nodes, F, n_bins, m) and got.dtype == np.float32
    assert np.array_equal(_bits(got), _bits(ref))


def _summation_gap_ok(got, binned, stats, node_id, n_nodes, n_bins):
    """|got - exact| <= rows_in_slot * 2^-24 * sum|terms| in every slot,
    the exact sum taken in float64."""
    m = stats.shape[1]
    exact = np.zeros((n_nodes, F, n_bins, m))
    absum = np.zeros_like(exact)
    rows = np.zeros((n_nodes, F, n_bins, 1))
    for f in range(F):
        np.add.at(exact, (node_id, f, binned[:, f]), stats.astype(np.float64))
        np.add.at(absum, (node_id, f, binned[:, f]),
                  np.abs(stats.astype(np.float64)))
        np.add.at(rows, (node_id, f, binned[:, f]), 1.0)
    gap = np.abs(np.asarray(got, np.float64) - exact)
    return bool((gap <= rows * 2.0 ** -24 * absum).all())


@pytest.mark.parametrize("n_nodes,n_bins,m", CASES)
def test_plain_and_pallas_within_summation_bound(n_nodes, n_bins, m):
    binned, stats, node_id = _inputs(n_nodes, n_bins, m, seed=1)
    pallas = np.asarray(_pallas_level_hist(
        jnp.asarray(binned), jnp.asarray(stats), jnp.asarray(node_id),
        n_nodes, n_bins))
    got = _plain(binned, stats, node_id, n_nodes, n_bins)
    assert _summation_gap_ok(got, binned, stats, node_id, n_nodes, n_bins)
    assert _summation_gap_ok(pallas, binned, stats, node_id, n_nodes, n_bins)


def test_zero_stat_rows_are_inert():
    """Rows whose stats are all zero change no slot's bits."""
    binned, stats, node_id = _inputs(8, 16, 3, seed=2)
    live = np.abs(stats).sum(1) > 0
    full = _plain(binned, stats, node_id, 8, 16)
    kept = _plain(binned[live], stats[live], node_id[live], 8, 16)
    assert (~live).any()
    assert np.array_equal(_bits(full), _bits(kept))


def test_column_major_and_stride_zero_views():
    """The trainer hands the kernel a column-major copy's transpose and
    the leaf call a stride-0 zero column: both read as (n, F)."""
    binned, stats, node_id = _inputs(4, 16, 3, seed=3)
    row_major = _plain(binned, stats, node_id, 4, 16)
    col = torch.from_numpy(np.ascontiguousarray(binned.T)).t()
    assert not col.is_contiguous()
    got = kh.level_hist(col, torch.from_numpy(stats),
                        torch.from_numpy(node_id), 4, 16).numpy()
    assert np.array_equal(_bits(got), _bits(row_major))


@pytest.mark.parametrize("n_leaves", [1, 16])
def test_leaf_call_equals_in_order_scatter(n_leaves):
    """``build_tree``'s leaf histogram: one all-zero column, ``n_bins = 1``,
    equal to the JAX package's ``zeros.at[node_id].add(stats)``."""
    rng = np.random.RandomState(4)
    stats = rng.randn(N_ROWS, 3).astype(np.float32)
    node_id = rng.randint(0, n_leaves, N_ROWS).astype(np.int32)
    ref = jnp.zeros((n_leaves, 3), jnp.float32).at[
        jnp.asarray(node_id)].add(jnp.asarray(stats))
    zero = torch.zeros((1, 1), dtype=torch.int32).expand(N_ROWS, 1)
    got = kh.level_hist(zero, torch.from_numpy(stats),
                        torch.from_numpy(node_id), n_leaves, 1)[:, 0, 0, :]
    assert np.array_equal(_bits(got.numpy()), _bits(ref))


@pytest.mark.parametrize("what", ["bin_high", "bin_negative", "node_high",
                                  "node_negative"])
def test_bad_ids_raise(what):
    binned, stats, node_id = _inputs(4, 16, 3, seed=5)
    if what == "bin_high":
        binned[3, 2] = 16
    elif what == "bin_negative":
        binned[5, 0] = -1
    elif what == "node_high":
        node_id[7] = 4
    else:
        node_id[0] = -1
    with pytest.raises(IndexError):
        _plain(binned, stats, node_id, 4, 16)


def _cuda_call(m=3, bin_dtype=torch.int32):
    kh.level_hist(torch.zeros((4, 2), dtype=bin_dtype, device="cuda"),
                  torch.zeros((4, m), device="cuda"),
                  torch.zeros(4, dtype=torch.int32, device="cuda"), 1, 2)


def test_cuda_tensors_launch_or_raise(monkeypatch):
    """A CUDA tensor never falls back to the plain version: without a
    card (and a compiler) the wrapper raises and counts nothing."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")
    monkeypatch.setattr(_build, "_target",
                        lambda n: _build.BUILD_DIR / "missing-lib.so")
    monkeypatch.setattr(_build, "_nvcc", no_nvcc)
    monkeypatch.setattr(kh, "_lib_handle", None)
    monkeypatch.setattr(_build, "_loaded", {})
    before = kh.launch_counts()
    with FakeTensorMode():
        with pytest.raises(RuntimeError, match="nvcc"):
            _cuda_call()
    assert kh.launch_counts() == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    meta = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        kh.level_hist(torch.zeros((4, 2), dtype=torch.int32, device="meta"),
                      meta, torch.zeros(4, dtype=torch.int32, device="meta"),
                      1, 2)
    with FakeTensorMode():
        with pytest.raises(ValueError, match="int32"):
            _cuda_call(bin_dtype=torch.int64)


def test_plain_version_counts_no_launch():
    kh.reset_launch_counts()
    binned, stats, node_id = _inputs(2, 4, 3, n=16)
    _plain(binned, stats, node_id, 2, 4)
    assert kh.launch_counts() == {"tree_hist": 0}


# ---------------------------------------------------------------------------
# the sorted kernel's plan, and the runs it must get right
# ---------------------------------------------------------------------------

# chip_smoke.py phase 8's shapes: (n, F, n_nodes, n_bins)
PHASE8 = [(48842, 14, nodes, 64) for nodes in (1, 2, 4, 8, 16, 32)] + [
    (48842, 1, 64, 1), (48842, 14, 8, 64), (48842, 14, 256, 64),
    (488420, 14, 32, 64), (48842, 14, 1, 1), (488420, 14, 1, 1),
    (488420, 1, 64, 1), (4097, 14, 32, 64), (1, 14, 32, 64),
    (48842, 14, 300, 64)]


@pytest.mark.parametrize("n,F,n_nodes,n_bins", PHASE8)
def test_hist_plan_scratch_within_budget(n, F, n_nodes, n_bins):
    """The counts table is at most half the keys' bytes plus one int per
    (feature, key); the tiles cover the rows, none of them empty."""
    Q = n_nodes * n_bins
    plan = kh._hist_plan(n, F, n_nodes, n_bins)
    R = plan.tile_rows
    assert R & (R - 1) == 0 and R >= max(1024, 2 * Q)
    assert 1 <= plan.tiles <= 32
    assert plan.tiles * R >= n and (plan.tiles - 1) * R < max(n, 1)
    assert plan.count_elems == F * Q * plan.tiles
    assert 4 * plan.count_elems <= 2 * n * F + 4 * F * Q
    assert plan.perm_elems == F * n
    assert plan.scratch_bytes == 4 * (plan.count_elems + plan.perm_elems)


def test_hist_plan_sizes_are_exact_past_32_bits():
    """Sizes that pass 2^31 stay exact: 256 nodes x 64 bins at 488,420
    rows, and a table of 2^31 - 1 rows by 65535 features."""
    plan = kh._hist_plan(488420, 14, 256, 64)
    assert plan.tile_rows == 32768 and plan.tiles == 15
    assert plan.count_elems == 14 * 16384 * 15
    big = kh._hist_plan(2 ** 31 - 1, 65535, 1, 64)
    assert big.perm_elems == (2 ** 31 - 1) * 65535 > 2 ** 32
    assert big.scratch_bytes == 4 * (big.count_elems + big.perm_elems)


@pytest.mark.parametrize("n,F,n_nodes,n_bins", [
    (2 ** 31, 14, 32, 64), (100, 65536, 1, 64), (100, 14, 1 << 17, 65),
    (100, 0, 1, 64), (100, 14, 0, 64), (100, 14, 1, 0), (-1, 14, 1, 64)])
def test_hist_plan_raises_past_the_kernel_limits(n, F, n_nodes, n_bins):
    with pytest.raises(ValueError):
        kh._hist_plan(n, F, n_nodes, n_bins)


def _runs_case(case, seed=11):
    """Inputs whose runs the sorted kernel must get right."""
    rng = np.random.RandomState(seed)
    n, n_nodes, n_bins, m = 3000, 4, 64, 3
    binned = rng.randint(0, n_bins, (n, F)).astype(np.int32)
    node_id = rng.randint(0, n_nodes, n).astype(np.int32)
    stats = (rng.randn(n, m) * 10.0 ** rng.randint(-3, 3, (n, 1))).astype(
        np.float32)
    if case == "one_slot":              # every row in one slot per feature
        binned[:] = 0
        node_id[:] = 0
        n_nodes, n_bins = 1, 1
    elif case == "run_past_a_tile":     # runs of about 1500 rows > 1024
        binned[:] = rng.randint(0, 2, (n, 1))
        node_id[:] = 0
        n_nodes, n_bins = 1, 2
    elif case == "mostly_empty":        # 3 of 64 bins of 32 nodes used
        binned = binned % 3 * 31
        n_nodes = 32
        node_id = rng.randint(0, n_nodes, n).astype(np.int32)
    elif case == "signed_zeros":        # +-0.0 rows inside long runs
        binned[:] = rng.randint(0, 2, (n, F))
        node_id[:] = 0
        n_nodes, n_bins = 1, 2
        zero = rng.rand(n)
        stats[zero < 0.1] = 0.0
        stats[(zero >= 0.1) & (zero < 0.2)] = -0.0
    return binned, stats, node_id, n_nodes, n_bins


@pytest.mark.parametrize("case", ["one_slot", "run_past_a_tile",
                                  "mostly_empty", "signed_zeros"])
def test_plain_runs_bitwise_vs_jax_default(case):
    binned, stats, node_id, n_nodes, n_bins = _runs_case(case)
    ref = jax_level_hist(jnp.asarray(binned), jnp.asarray(stats),
                         jnp.asarray(node_id), n_nodes, n_bins,
                         use_onehot=False)
    got = _plain(binned, stats, node_id, n_nodes, n_bins)
    assert np.array_equal(_bits(got), _bits(ref))
    if case == "mostly_empty":
        empty = np.ones(n_bins, bool)
        empty[[0, 31, 62]] = False
        assert not _bits(got)[:, :, empty].any()     # +0.0, every bit clear


class _FakeFn:
    """A C function of a fake library: records its arguments and checks
    them against the argtypes the wrapper declared."""

    def __init__(self, rc=0):
        self.argtypes, self.restype, self.calls, self.rc = None, None, [], rc

    def __call__(self, *args):
        assert self.argtypes is not None and len(args) == len(self.argtypes)
        assert all(isinstance(a, int) for a in args)
        self.calls.append(args)
        return self.rc


def test_cuda_tensors_reach_the_kernel_not_the_plain_version(monkeypatch):
    """With a library in place, a CUDA tensor goes to the C function, in
    one call with the plan's tile rows, tiles and scratch, and counts one
    launch; the plain version is never called."""
    import types
    fake = types.SimpleNamespace(alink_tree_hist=_FakeFn(),
                                 alink_tree_hist_error_string=_FakeFn())
    monkeypatch.setattr(kh, "_lib_handle", None)
    monkeypatch.setattr(_build, "load_library", lambda name: fake)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None:
                        types.SimpleNamespace(cuda_stream=77))

    def no_plain(*a):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(kh, "level_hist_plain", no_plain)
    kh.reset_launch_counts()
    with FakeTensorMode():
        out = kh.level_hist(torch.zeros((5000, 3), dtype=torch.int32,
                                        device="cuda"),
                            torch.zeros((5000, 3), device="cuda"),
                            torch.zeros(5000, dtype=torch.int32,
                                        device="cuda"), 4, 16)
    assert tuple(out.shape) == (4, 3, 16, 3)
    (args,) = fake.alink_tree_hist.calls
    plan = kh._hist_plan(5000, 3, 4, 16)
    assert args[7:13] == (5000, 3, 4, 16, plan.tile_rows, plan.tiles)
    assert args[-1] == 77
    assert kh.launch_counts() == {"tree_hist": 1}
