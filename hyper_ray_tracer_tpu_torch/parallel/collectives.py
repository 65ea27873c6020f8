"""Deterministic reductions over ranks: an all-gather, then a fold in rank
order.

The JAX package's ``psum`` becomes ``all_gather`` followed by a left to
right sum in the group's rank order, never ``all_reduce``: NCCL's ring
and gloo's tree order the adds by their own schedules, so an
``all_reduce`` would part the low bits of an image or a gradient between
backends and world sizes.  A fold in rank order gives every rank the same
bits, run after run, on either backend.  The gather runs in the span
``all_gather`` and the fold in the span ``fold`` (``utils/profiling.py``).
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist

from ..utils.profiling import span


@span("fold")
def fold(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """``parts[0] + parts[1] + ...``, left to right."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


@span("all_gather")
def all_gather(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank's ``t`` (same shape and dtype on each) in ``group``'s
    rank order; ``group=None`` is a group of this rank alone (a mesh
    axis of one rank), with no collective."""
    if group is None:
        return [t]
    t = t.contiguous()
    parts = [torch.empty_like(t)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return parts


def gather_fold(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's ``t`` over ``group``, folded in rank order:
    the same bits on every rank."""
    return fold(all_gather(t, group))


class _FoldSum(torch.autograd.Function):
    """``gather_fold`` with a gradient: each rank's ``t`` enters the sum
    with weight 1, so the sum's gradient is ``t``'s, unchanged.  Every
    rank of the group computes the same sum and the same loss downstream
    of it, so the gradient that reaches each rank's ``t`` is the whole
    loss's gradient with respect to that rank's part."""

    @staticmethod
    def forward(ctx, t, group):
        return gather_fold(t.detach(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def fold_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """``gather_fold`` that autograd passes through (``_FoldSum``)."""
    if group is None:
        return t
    return _FoldSum.apply(t, group)
