"""A row gather whose backward sums in one fixed order (K3).

``gather_rows(table, idx)`` is ``table.index_select(0, idx)`` with a
backward that is reproducible from run to run: the gradient of row ``r``
is the sum of the cotangent rows of the lanes that took it, added in one
order that does not depend on the scheduling.  ``index_select``'s own
backward, ``index_add_``, adds them with float atomics on the card, in
whatever order the lanes arrive, so its sums may differ in their last
bits from one run to the next.  The winner's row gather
(``ops/intersect.gather_prim_shade_packed``: every lane of a bounce into
the scene's few hundred primitives) and the texel gather
(``ops/textures.texture_value``) go through it.

The order, ``segment_sum``'s contract:

1. the lanes are sorted by row, stably (a sort of integers has one
   answer): position ``p`` holds lane ``order[p]`` of row ``rows[p]``,
   and row ``r``'s lanes take the positions ``[S_r, S_r + m_r)`` in lane
   order;
2. a pairwise tree over the positions, aligned at position 0: for
   ``h = 1, 2, 4, ...``, every node ``[a, a + 2h)`` (``a`` a multiple of
   ``2h``) whose middle ``a + h`` falls inside a row (positions
   ``a + h - 1`` and ``a + h`` both of row ``r``) adds the partial sum of
   ``r``'s lanes in its right half, held at position ``a + h``, to the
   partial sum of ``r``'s lanes in its left half, held at position
   ``max(a, S_r)``;
3. row ``r``'s sum is then the value held at ``S_r``; a row no lane took
   gets 0.

Every addition is one float32 addition with one writer, so the sums do
not depend on the scheduling.  Nothing in the order depends on how a
kernel cuts the positions: K3 runs the steps below ``CHUNK`` inside one
block and the steps above it in levels of ``FAN_OUT`` units, and the tests
place rows across those edges to hold it there.

Two implementations of that contract, equal bit for bit (they perform
the same IEEE additions):

* ``segment_sum``: the wrapper of the hand-written Hopper kernel K3
  (``csrc/segment_sum.cu``, which sorts the lanes itself; not a TPU
  kernel: it replaces ``index_add_`` in the backward).  A CPU tensor
  takes the plain version; a CUDA tensor launches the kernel or raises.
* ``segment_sum_plain``: the same sums in plain torch, ``torch.sort``
  and then one vectorised step per ``h``, over the nodes whose middle
  falls inside a row; memory in proportion to the lanes.

Tracing (``utils/profiling.py``): each call of K3 runs in the span
``K3`` and counts in ``K3.launches`` and its lanes in ``K3.lanes``.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import cuda_build

CHUNK = 256  # positions a K3 block sums alone: csrc/segment_sum.cu kChunk
FAN_OUT = 32  # units a level of K3 combines: csrc/segment_sum.cu kFanOut
ONE_PASS_ROWS = 2048  # rows K3 sorts in one pass: csrc/segment_sum.cu kMaxBins
MAX_WIDTH = 256  # the widest row K3 takes


def segment_sum_plain(src, idx, n_rows: int):
    """[n_rows, F]: row ``r`` is the sum of the rows of ``src`` [N, F]
    whose ``idx`` [N] is ``r``, in the module's fixed order."""
    n, f = src.shape
    out = torch.zeros((n_rows, f), dtype=src.dtype, device=src.device)
    if n == 0:
        return out
    rows, order = torch.sort(idx, stable=True)
    vals = src[order]
    pos = torch.arange(n, device=src.device)
    first = torch.ones(n, dtype=torch.bool, device=src.device)
    first[1:] = rows[1:] != rows[:-1]
    # start[p]: S_r of the row at position p.
    start = torch.where(first, pos, 0).cummax(0).values
    h = 1
    while h < n:
        mid = torch.arange(h, n, 2 * h, device=src.device)
        mid = mid[rows[mid - 1] == rows[mid]]
        left = torch.maximum(mid - h, start[mid])  # one per node
        vals[left] = vals[left] + vals[mid]
        h *= 2
    out[rows[first]] = vals[first]
    return out


def _bind(lib):
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    size = lib.hrt_segment_sum_workspace
    size.argtypes = [c_int, c_int, c_int, ctypes.POINTER(ctypes.c_longlong)]
    size.restype = c_int
    fn = lib.hrt_segment_sum
    fn.argtypes = [ptr, c_int, ptr, c_int, c_int, c_int, ptr, ptr, ptr, ptr]
    fn.restype = c_int
    return size, fn


def segment_sum(src, idx, n_rows: int):
    """``segment_sum_plain``'s sums of ``src`` [N, F] float32 by ``idx``
    [N] (integers in [0, n_rows); on the card one outside traps the
    kernel).  A CPU tensor takes the plain version; a CUDA tensor
    launches K3 (building it on first use: a fill and three kernels, no
    ``torch.sort``) or raises.  A call is traced as one launch of ``K3``
    (``cuda_build.launch``)."""
    device = src.device
    if device.type == "cpu":
        return segment_sum_plain(src, idx, n_rows)
    if device.type != "cuda":
        raise ValueError(f"segment_sum: unsupported device {device}")
    if src.dim() != 2:
        raise ValueError(f"segment_sum: src has shape {tuple(src.shape)}, "
                         "expected [N, F]")
    n, f = src.shape
    cuda_build.check_arg("segment_sum", "src", src, (n, f), torch.float32,
                         device)
    if idx.device != device or idx.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"segment_sum: idx must be an integer tensor on "
                         f"{device}, got {idx.dtype} on {idx.device}")
    if tuple(idx.shape) != (n,):
        raise ValueError(f"segment_sum: idx has shape {tuple(idx.shape)}, "
                         f"expected {(n,)}")
    if f > MAX_WIDTH:
        raise ValueError(f"segment_sum: rows of {f} exceed {MAX_WIDTH}")
    if max(n, n_rows) * max(f, 1) >= 2**31:
        raise ValueError(f"segment_sum: {n} lanes or {n_rows} rows of {f} "
                         "exceed 32-bit indexing")
    out = torch.empty((n_rows, f), dtype=torch.float32, device=device)
    if n == 0 or f == 0 or n_rows == 0:
        return out.zero_()
    size, fn = _bind(cuda_build.load("segment_sum"))
    nbytes = (ctypes.c_longlong * 2)()
    if size(n, f, n_rows, nbytes) != 0:
        raise ValueError(f"segment_sum: no workspace for {n} lanes into "
                         f"{n_rows} rows of {f}")
    # The kernel's counters, histograms and look-back words start at 0;
    # the sorted lanes and the partial sums go to `work`.
    zeroed = torch.zeros(nbytes[0], dtype=torch.uint8, device=device)
    work = torch.empty(nbytes[1], dtype=torch.uint8, device=device)
    idx = idx.contiguous()
    cuda_build.launch("segment_sum", fn, device, idx.data_ptr(),
                      int(idx.dtype == torch.int64), src.data_ptr(), n, f,
                      n_rows, zeroed.data_ptr(), work.data_ptr(),
                      out.data_ptr(), tag="K3", lanes=n)
    return out


class _GatherRows(torch.autograd.Function):
    """``index_select`` forward, ``segment_sum`` backward."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, grad_out):
        (idx,) = ctx.saved_tensors
        return segment_sum(grad_out.contiguous(), idx, ctx.n_rows), None


def gather_rows(table, idx):
    """``table.index_select(0, idx)`` for ``table`` [R, F] and ``idx`` [N],
    differentiable in ``table`` with a reproducible backward
    (``segment_sum``)."""
    return _GatherRows.apply(table, idx)
