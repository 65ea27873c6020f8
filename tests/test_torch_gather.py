"""The reproducible row gather (``ops/gather.py``) on the CPU: the fixed
order of ``segment_sum_plain`` (a pairwise tree over the sorted
positions) against a float64 ``index_add_`` and against the contract
written out row by row, cases where the order decides the sum,
``gather_rows``' gradient against ``index_select``'s, and the compaction
gather whose ``index_select`` backward is exact because its indices are
unique.  K3, the kernel, is
held to ``segment_sum_plain`` bit for bit in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the tensors are small, and the suite runs in
# several worker processes that would contend for the cores.
torch.set_num_threads(1)

from hyper_ray_tracer_tpu_torch.ops.gather import (  # noqa: E402
    CHUNK,
    FAN_OUT,
    gather_rows,
    segment_sum,
    segment_sum_plain,
)
from hyper_ray_tracer_tpu_torch.utils.profiling import counter  # noqa: E402

F32_EPS = float(np.finfo(np.float32).eps)


def _case(n, n_rows, f, skew, seed):
    """Cotangent rows [n, f] over several magnitudes and their rows: with
    ``skew`` seven lanes in ten take row 0 (a ground sphere)."""
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((n, f)) * 10.0 ** rng.integers(-4, 4, (n, 1))
    idx = rng.integers(0, n_rows, n)
    if skew:
        idx = np.where(rng.uniform(size=n) < 0.7, 0, idx)
    return torch.from_numpy(src.astype(np.float32)), torch.from_numpy(idx)


@pytest.mark.parametrize("n,n_rows,f,skew", [
    (0, 3, 2, False), (1, 1, 1, False), (5, 9, 2, False),
    (CHUNK - 1, 4, 3, True), (CHUNK, 4, 3, True), (CHUNK + 1, 7, 20, True),
    (3000, 50, 19, False), (5000, 1, 3, True),
    (40 * CHUNK + 3, 20_000, 3, True)])
def test_segment_sum_plain_against_float64_index_add(n, n_rows, f, skew):
    """Each row within the recursive-summation bound of the float64 sum:
    (lanes of the row) * eps * (the row's sum of |x|); rows no lane took
    are exactly 0."""
    src, idx = _case(n, n_rows, f, skew, seed=n + f)
    got = segment_sum_plain(src, idx, n_rows)
    ref = torch.zeros((n_rows, f), dtype=torch.float64).index_add_(
        0, idx, src.double())
    mag = torch.zeros((n_rows, f), dtype=torch.float64).index_add_(
        0, idx, src.double().abs())
    count = torch.bincount(idx, minlength=n_rows).double()[:, None]
    assert got.dtype == torch.float32 and got.shape == (n_rows, f)
    assert ((got.double() - ref).abs() <= count * F32_EPS * mag).all()
    assert (got[count[:, 0] == 0] == 0).all()


def _pattern(offset):
    """Row 1's lanes 1e8, 1, -1e8, 1 at sorted positions offset..offset+3,
    after ``offset`` lanes of row 0 (all 0.0)."""
    src = torch.cat([torch.zeros((offset, 1)),
                     torch.tensor([[1e8], [1.0], [-1e8], [1.0]])])
    idx = torch.cat([torch.zeros(offset, dtype=torch.int64),
                     torch.ones(4, dtype=torch.int64)])
    return src, idx


def test_the_order_decides_the_sum():
    """1e8, 1, -1e8, 1 into one row: in float32 (1e8 + 1) rounds to 1e8
    and (1 - 1e8) to -1e8, so the sum is the tree's.  With the row at
    positions 0-3 the tree adds the pairs first, 1e8 + -1e8: 0.0, where
    left to right gives 1.0 and float64 2.0.  Across the edge of one of
    K3's chunks (positions CHUNK - 2 .. CHUNK + 1) the pairs are the same
    and so is the sum."""
    for offset in (0, CHUNK - 2):
        src, idx = _pattern(offset)
        assert segment_sum_plain(src, idx, 2)[1].item() == 0.0
        assert float(src.double().sum()) == 2.0


@pytest.mark.parametrize("offset,want", [
    (1, 1.0), (2, 0.0), (3, 0.0), (CHUNK - 3, 1.0),
    (CHUNK * FAN_OUT - 3, 1.0), (CHUNK * FAN_OUT - 1, 0.0)])
def test_the_tree_is_aligned_at_position_zero(offset, want):
    """The tree's nodes are aligned at position 0, not at the row: after
    one lane of another row the same four lanes make the nodes
    (1 + -1e8), then 1e8 + that, then + 1: 1.0.  Likewise where they
    straddle the edge of one of K3's chunks (CHUNK) or of a unit of its
    level above (CHUNK * FAN_OUT), where the kernel hands a row's
    partial sums on."""
    src, idx = _pattern(offset)
    assert segment_sum_plain(src, idx, 2)[1].item() == want


def _contract_sums(src, idx, n_rows):
    """The contract written out row by row in float32 numpy: each row's
    lanes at their stably sorted positions, summed node by node from the
    root of the pairwise tree aligned at position 0, a node adding its
    halves' sums when both hold lanes of the row."""
    x = src.numpy()[np.argsort(idx.numpy(), kind="stable")]
    rows = np.sort(idx.numpy(), kind="stable")
    top = 1
    while top < len(rows):
        top *= 2
    want = np.zeros((n_rows, src.shape[1]), np.float32)
    for r in np.unique(rows):
        lo, hi = np.searchsorted(rows, [r, r + 1])

        def node(a, size):
            if a + size <= lo or a >= hi:
                return None
            if size == 1:
                return x[a]
            left = node(a, size // 2)
            right = node(a + size // 2, size // 2)
            if left is None or right is None:
                return right if left is None else left
            return left + right

        want[r] = node(0, top)
    return torch.from_numpy(want)


def test_segment_sum_plain_follows_its_order_bit_for_bit():
    """Against the contract written out lane by lane in float32: a texel
    gather's shape (rows of 3, most rows one lane, row 0 spread over a
    dozen of K3's chunks)."""
    src, idx = _case(12 * CHUNK + 5, 5_000, 3, True, seed=7)
    assert torch.equal(segment_sum_plain(src, idx, 5_000),
                       _contract_sums(src, idx, 5_000))


@pytest.mark.parametrize("n,n_rows,f", [
    (3 * CHUNK * FAN_OUT + 77, 5, 2),
    (CHUNK * FAN_OUT * FAN_OUT + 1_001, 3, 1)])
def test_segment_sum_plain_follows_its_order_on_long_rows(n, n_rows, f):
    """The same on rows whose lanes span more of K3's chunks than one of
    its levels combines (FAN_OUT): row 0 takes seven lanes in ten, so its
    chunks' partial sums are combined one and two levels above the
    chunks."""
    src, idx = _case(n, n_rows, f, True, seed=n)
    assert torch.equal(segment_sum_plain(src, idx, n_rows),
                       _contract_sums(src, idx, n_rows))


def test_segment_sum_on_cpu_takes_the_plain_version():
    src, idx = _case(700, 11, 5, True, seed=2)
    before = counter("K3.launches")
    assert torch.equal(segment_sum(src, idx, 11),
                       segment_sum_plain(src, idx, 11))
    assert counter("K3.launches") == before


def test_gather_rows_gradient_matches_index_select():
    """Forward: ``index_select`` bit for bit.  Backward: the same sums in
    another order, so equal to rounding (the float64 bound above), and
    the same backward twice is bit-equal."""
    src, idx = _case(2 * CHUNK + 37, 13, 6, True, seed=4)
    table = torch.randn((13, 6), generator=torch.Generator().manual_seed(0))

    def grad(fn):
        t = table.clone().requires_grad_()
        out = fn(t, idx)
        (g,) = torch.autograd.grad(out, t, src)
        return out.detach(), g

    out_g, g_g = grad(gather_rows)
    out_s, g_s = grad(lambda t, i: t.index_select(0, i))
    assert torch.equal(out_g, out_s)
    mag = torch.zeros((13, 6), dtype=torch.float64).index_add_(
        0, idx, src.double().abs())
    count = torch.bincount(idx, minlength=13).double()[:, None]
    assert ((g_g.double() - g_s.double()).abs()
            <= 2 * count * F32_EPS * mag).all()
    assert torch.equal(grad(gather_rows)[1], g_g)
    assert not gather_rows(table, idx).requires_grad


def test_compaction_gather_backward_is_exact():
    """``render.trace_paths`` keeps ``index_select`` for the surviving
    lanes: ``keep`` holds each lane once, so each lane's gradient is one
    addend onto 0, the cotangent itself, whatever the order of the
    additions, and lanes that died get 0."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((1000, 3), generator=gen, requires_grad=True)
    keep = torch.randperm(1000, generator=gen)[:613].sort().values
    g = torch.randn((613, 3), generator=gen)
    (got,) = torch.autograd.grad(x.index_select(0, keep), x, g)
    want = torch.zeros_like(x)
    want[keep] = g
    assert torch.equal(got, want)
