"""The reproducible row gather (``ops/gather.py``) on the CPU: the fixed
order of ``segment_sum_plain`` against a float64 ``index_add_``, a case
where the order decides the sum, ``gather_rows``' gradient against
``index_select``'s, and the compaction gather whose ``index_select``
backward is exact because its indices are unique.  K3, the kernel, is
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
    gather_rows,
    segment_sum,
    segment_sum_plain,
)

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


def test_the_order_decides_the_sum():
    """1e8, 1, -1e8, 1 into one row: summed left to right in float32
    ((1e8 + 1) rounds to 1e8), 1.0, where float64 gives 2.0; the sorted
    order is the lanes' order, since the sort is stable.  Across a chunk
    boundary the pieces are summed in chunk order too."""
    src = torch.tensor([[1e8], [1.0], [-1e8], [1.0]])
    idx = torch.zeros(4, dtype=torch.int64)
    assert segment_sum_plain(src, idx, 1).item() == 1.0
    assert float(src.double().sum()) == 2.0
    # Row 1's lanes at sorted positions CHUNK - 2 .. CHUNK + 1 form two
    # pieces, (1e8 + 1) and (-1e8 + 1), which round to 1e8 and -1e8: the
    # row sums to 0.
    pad = CHUNK - 2
    src = torch.cat([torch.zeros((pad, 1)), src])
    idx = torch.cat([torch.zeros(pad, dtype=torch.int64),
                     torch.ones(4, dtype=torch.int64)])
    assert segment_sum_plain(src, idx, 2)[1].item() == 0.0


def test_segment_sum_plain_follows_its_order_bit_for_bit():
    """Against the contract written out lane by lane in float32: a texel
    gather's shape (rows of 3, most rows one lane, row 0 spread over a
    dozen chunks), each row's lanes in their sorted positions, summed
    left to right within a chunk, the chunks' pieces then left to right."""
    src, idx = _case(12 * CHUNK + 5, 5_000, 3, True, seed=7)
    got = segment_sum_plain(src, idx, 5_000)
    x = src.numpy()
    want = np.zeros((5_000, 3), np.float32)
    for r in np.unique(idx.numpy()):
        pos = np.flatnonzero(np.sort(idx.numpy(), kind="stable") == r)
        lanes = np.flatnonzero(idx.numpy() == r)  # stable: in lane order
        pieces = []
        for chunk in np.unique(pos // CHUNK):
            acc = None
            for lane in lanes[pos // CHUNK == chunk]:
                acc = x[lane] if acc is None else acc + x[lane]
            pieces.append(acc)
        total = pieces[0]
        for p in pieces[1:]:
            total = total + p
        want[r] = total
    assert torch.equal(got, torch.from_numpy(want))


def test_segment_sum_on_cpu_takes_the_plain_version():
    src, idx = _case(700, 11, 5, True, seed=2)
    before = segment_sum.launches
    assert torch.equal(segment_sum(src, idx, 11),
                       segment_sum_plain(src, idx, 11))
    assert segment_sum.launches == before


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
