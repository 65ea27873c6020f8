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

The order, ``segment_sum``'s contract: the lanes are sorted by row,
stably (``torch.sort(..., stable=True)``: a sort of integers has one
answer), and cut into chunks of ``CHUNK`` sorted lanes.  A row's lanes
in one chunk form a piece; each piece is summed left to right, and each
row's pieces are then summed left to right, in chunk order.  A row no
lane took gets 0.

Two implementations of that contract, equal bit for bit (they perform
the same IEEE additions in the same order):

* ``segment_sum``: the wrapper of the hand-written Hopper kernel K3
  (``csrc/segment_sum.cu``; not a TPU kernel: it replaces ``index_add_``
  in the backward).  A CPU tensor takes the plain version; a CUDA tensor
  launches the kernel or raises.
* ``segment_sum_plain``: the same sums in plain torch, a loop over the
  positions of a chunk and then over the pieces of a row, each step
  vectorised over the chunks or the rows; memory in proportion to the
  lanes.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils import cuda_build

CHUNK = 256  # sorted lanes a piece spans at most: csrc/segment_sum.cu kChunk
MAX_WIDTH = 256  # the widest row K3 takes: csrc/segment_sum.cu kThreads


def segment_sum_plain(src, idx, n_rows: int):
    """[n_rows, F]: row ``r`` is the sum of the rows of ``src`` [N, F]
    whose ``idx`` [N] is ``r``, in the module's fixed order."""
    n, f = src.shape
    out = torch.zeros((n_rows, f), dtype=src.dtype, device=src.device)
    if n == 0:
        return out
    # The rows sorted stably; order[i] is the lane at sorted position i.
    rows, order = torch.sort(idx, stable=True)
    vals = src[order]
    n_chunks = -(-n // CHUNK)
    pad = n_chunks * CHUNK - n
    vals = torch.cat([vals, vals.new_zeros((pad, f))]).view(
        n_chunks, CHUNK, f)
    rows_c = torch.cat([rows, rows.new_full((pad,), -1)]).view(
        n_chunks, CHUNK)
    # Each piece left to right: acc[:, j] is the sum of its piece up to
    # position j of the chunk.
    acc = vals.clone()
    for j in range(1, min(CHUNK, n)):
        same = (rows_c[:, j] == rows_c[:, j - 1])[:, None]
        acc[:, j] = torch.where(same, acc[:, j - 1] + vals[:, j],
                                vals[:, j])
    # A piece ends at a chunk's last position or where the row changes.
    pos = torch.arange(n, device=src.device)
    nxt = torch.cat([rows[1:], rows.new_full((1,), -1)])
    ends = ((pos % CHUNK == CHUNK - 1) | (nxt != rows)).nonzero().squeeze(1)
    part = acc.view(-1, f)[ends]
    part_row = rows[ends]
    # Each row's pieces left to right, vectorised over the rows: step k
    # adds the k-th piece of each row that has more than k, so the work
    # and memory are those of the pieces, however long the longest row.
    first = torch.ones_like(part_row, dtype=torch.bool)
    first[1:] = part_row[1:] != part_row[:-1]
    starts = first.nonzero().squeeze(1)
    counts = torch.diff(starts, append=starts.new_full((1,), len(part_row)))
    total = part[starts]
    live = torch.arange(len(starts), device=src.device)
    for k in range(1, int(counts.max())):
        live = live[counts[live] > k]
        total[live] = total[live] + part[starts[live] + k]
    out[part_row[starts]] = total
    return out


def _bind(lib):
    fn = lib.hrt_segment_sum
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr, ptr, ptr, c_int, c_int, c_int, ptr, ptr, ptr, ptr]
    fn.restype = c_int
    return fn


def segment_sum(src, idx, n_rows: int):
    """``segment_sum_plain``'s sums of ``src`` [N, F] float32 by ``idx``
    [N] (integers in [0, n_rows)).  A CPU tensor takes the plain version;
    a CUDA tensor launches K3 (building it on first use) or raises.
    Counts its kernel launches in ``segment_sum.launches``."""
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
    rows, order = torch.sort(idx.to(torch.int32), stable=True)
    heads = torch.empty((-(-n // CHUNK), f), dtype=torch.float32,
                        device=device)
    bounds = torch.zeros((2, n_rows), dtype=torch.int32, device=device)
    fn = _bind(cuda_build.load("segment_sum"))
    cuda_build.launch("segment_sum", fn, device, order.data_ptr(),
                      rows.data_ptr(), src.data_ptr(), n, f, n_rows,
                      heads.data_ptr(), bounds.data_ptr(), out.data_ptr())
    segment_sum.launches += 1
    return out


segment_sum.launches = 0


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
