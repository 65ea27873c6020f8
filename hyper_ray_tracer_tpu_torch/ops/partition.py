"""Lane partitioning by primitive-group box overlap: the partitioned sweep.

The sweeps test every (ray, primitive) pair.  Some scenes hold a few
large, compact runs of primitives: `final`'s 1,000-sphere cloud and its
400-box grid, whose boxes most ray segments miss.  A partitioned bounce
computes, for each lane, which groups' boxes its segment can meet (its
mask, ``group_mask``), orders the lanes by it (the compaction's
permutation) and hands the mask to the sweep kernel, which folds a
group's primitives only into the lanes whose mask has the group's bit.
The JAX package's ``ops/partition.py`` is the reference; this is the
port's copy of its host-side group choice and its overlap test, on torch
tensors.

The masks: with G groups (at most ``MAX_GROUPS``), bit G-1-i of a lane's
mask says "meets group i", the integer mask of the JAX package's
``lane_layout_cat``, and the lane's category is C-1-mask (C = 2**G), so
that categories in ascending order hold descending masks, group 0's lanes
first.

The test is conservative (``overlap_masks``): a lane whose mask lacks a
group cannot hit any of that group's primitives, medium boundaries
included.  So the partitioned sweep picks the same winner as the plain
sweep on every lane, and the port's partitioned render equals its plain
render bit for bit (the sweeps' contract: ``ops/typed_sweep.py``,
``ops/sphere_sweep.py``).

Not ported: ``group_rows`` and ``rows_for_tile``, which turn the JAX
package's static bucket layout into static lane ranges for XLA; the
port's kernels read each lane's mask instead.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..models.scene import PT_BOX, PT_MEDIUM_SPHERE, PT_SPHERE
from ..utils.profiling import host_sync

# A group is an (edge-trimmed) type run of at least this many primitives.
PART_MIN_PRIMS = 128
# The fewest lanes a partitioned bounce runs on: below it the whole sweep
# is cheap, and the mask, its counts and the permutation cost more than
# the pairs they skip.
PART_MIN_LANES = 65536
# Two groups, four categories.
MAX_GROUPS = 2
# The least share of the pairs a partitioned bounce must skip (the JAX
# package's render.py:1129-1131).
PART_SAVED_MIN = 0.15


class PartGroup(NamedTuple):
    start: int  # primitive range [start, end) in canonical order
    end: int
    # The union of the members' world boxes over the shutter (the scene's
    # baked aabb_min / aabb_max), as float tuples.
    bmin: Tuple[float, float, float]
    bmax: Tuple[float, float, float]
    # Every member is a sphere, moving sphere, medium sphere or box with
    # no transform: then ``device_group_aabbs`` recomputes the union from
    # the current p0 / p1 / radius, which a train step needs.
    dynamic_ok: bool = False


def _trim_run(amin, amax, a: int, b: int):
    """Shrink [a, b) from one edge when a few outlying primitives inflate
    the union box (`final`'s 6 hero spheres share the cloud's sphere
    run): keep at least 80% of the run, trim only for a 4x smaller
    volume.  The JAX package's ``_trim_run``, copied."""
    size = b - a
    keep = max(PART_MIN_PRIMS, (size * 4) // 5)
    max_trim = size - keep
    if max_trim <= 0:
        return a, b

    def vol(mn, mx):
        e = np.maximum(mx - mn, 0.0)
        return float(e[..., 0] * e[..., 1] * e[..., 2])

    suf_mn = np.minimum.accumulate(amin[a:b][::-1], 0)[::-1]
    suf_mx = np.maximum.accumulate(amax[a:b][::-1], 0)[::-1]
    pre_mn = np.minimum.accumulate(amin[a:b], 0)
    pre_mx = np.maximum.accumulate(amax[a:b], 0)
    v0 = vol(suf_mn[0], suf_mx[0])
    best = (a, b, v0)
    for k in range(1, max_trim + 1):
        vf = vol(suf_mn[k], suf_mx[k])
        if vf < best[2]:
            best = (a + k, b, vf)
        vb = vol(pre_mn[size - 1 - k], pre_mx[size - 1 - k])
        if vb < best[2]:
            best = (a, b - k, vb)
    a2, b2, v = best
    return (a2, b2) if v * 4.0 <= v0 else (a, b)


def partition_groups(host_geom, n_prims: int) -> Tuple[PartGroup, ...]:
    """Up to ``MAX_GROUPS`` groups of the NumPy geometry ``host_geom``:
    the (edge-trimmed) type runs of at least ``PART_MIN_PRIMS``
    primitives, largest first.  The JAX package's ``partition_groups``
    on the port's ``type_runs``."""
    from .typed_sweep import type_runs

    amin = np.asarray(host_geom.aabb_min)
    amax = np.asarray(host_geom.aabb_max)
    runs = []
    for a, b, *_ in type_runs(host_geom, n_prims):
        if b - a >= PART_MIN_PRIMS:
            runs.append(_trim_run(amin, amax, a, b))
    runs = [r for r in runs if r[1] - r[0] >= PART_MIN_PRIMS]
    runs.sort(key=lambda r: r[0] - r[1])  # largest first
    pt = np.asarray(host_geom.ptype)
    rot = np.asarray(host_geom.rot)
    trans = np.asarray(host_geom.trans)
    eye = np.eye(3, dtype=rot.dtype)
    gs = []
    for a, b in runs[:MAX_GROUPS]:
        dyn = bool(
            np.isin(pt[a:b], [PT_SPHERE, PT_MEDIUM_SPHERE, PT_BOX]).all()
            and (rot[a:b] == eye).all() and (trans[a:b] == 0).all())
        gs.append(PartGroup(
            int(a), int(b),
            tuple(float(v) for v in amin[a:b].min(0).astype(np.float32)),
            tuple(float(v) for v in amax[a:b].max(0).astype(np.float32)),
            dyn))
    return tuple(gs)


def baked_aabbs(groups, device):
    """Each group's (bmin, bmax) as float32 [3] tensors on ``device``."""
    return tuple(
        (host_sync(torch.tensor(g.bmin, dtype=torch.float32,
                                device=device)),
         host_sync(torch.tensor(g.bmax, dtype=torch.float32,
                                device=device)))
        for g in groups)


def device_group_aabbs(groups, geom):
    """Each group's (bmin, bmax) from the current ``geom.p0``, ``p1`` and
    ``radius`` (tensors): the union of min(p0, p1) - |r|max and
    max(p0, p1) + |r|max over its members, which covers static, moving
    and medium spheres and boxes (r = 0, corners p0 / p1) for every value
    of the parameters.  Only for ``dynamic_ok`` groups.  The radius is
    taken by magnitude: a hollow sphere's is negative."""
    out = []
    for g in groups:
        if not g.dynamic_ok:
            raise ValueError(f"group [{g.start}, {g.end}) has no box "
                             "computable from its parameters")
        p0 = geom.p0[g.start:g.end]
        p1 = geom.p1[g.start:g.end]
        r_max = geom.radius[g.start:g.end].abs().amax()
        out.append((torch.minimum(p0, p1).amin(0) - r_max,
                    torch.maximum(p0, p1).amax(0) + r_max))
    return tuple(out)


def overlap_masks(groups, o, d, aabbs=None):
    """[N, G] bool: the segment t in (0, inf) of ray (o, d) may meet group
    i's box.  Conservative: |d| is floored (an axis-parallel ray on a slab
    plane gets a huge finite interval, never a NaN miss), the comparison
    is non-strict, and the box is padded by a relative epsilon, so the
    rounding of the slab products cannot lose a primitive on the box's
    face.  A false positive costs pairs; a false negative cannot happen.
    ``aabbs``: per-group (bmin, bmax) tensors (the scene's, or
    ``device_group_aabbs``'); default the groups' baked boxes.  The JAX
    package's ``overlap_masks``, in the same float32 operations."""
    if aabbs is None:
        aabbs = baked_aabbs(groups, o.device)
    if not aabbs:
        return torch.zeros((o.shape[0], 0), dtype=torch.bool,
                           device=o.device)
    # Every group at once, [N, G, 3]: the same float32 operations on each
    # element as one group at a time.
    bmin = torch.stack([lo for lo, _ in aabbs])
    bmax = torch.stack([hi for _, hi in aabbs])
    d_safe = torch.where(d.abs() < 1e-20, 1e-20, d)
    inv = (1.0 / d_safe)[:, None]
    pad = 1e-5 * (bmax - bmin) + 1e-6
    t0 = (bmin - pad - o[:, None]) * inv
    t1 = (bmax + pad - o[:, None]) * inv
    lo = torch.minimum(t0, t1).amax(-1)
    hi = torch.maximum(t0, t1).amin(-1)
    return (hi >= lo) & (hi >= 0.0)


def group_bit(n_groups: int, i: int) -> int:
    """The bit of group i in a lane's mask."""
    return 1 << (n_groups - 1 - i)


def group_mask(groups, o, d, aabbs=None) -> torch.Tensor:
    """Each lane's group mask, uint8 [N]: bit G-1-i set when the lane may
    meet group i (``overlap_masks``), the integer mask of the JAX
    package's ``lane_layout_cat``.  This is what the sweeps' ``mask``
    argument reads."""
    m = overlap_masks(groups, o, d, aabbs).to(torch.uint8)
    mask = torch.zeros(o.shape[0], dtype=torch.uint8, device=o.device)
    for i in range(len(groups)):
        mask |= m[:, i] << (len(groups) - 1 - i)
    return mask


def lane_layout_cat(groups, o, d, aabbs=None) -> torch.Tensor:
    """Each lane's category, int32 [N]: C-1-mask, so that ascending
    categories hold descending masks (group 0's lanes first).  The JAX
    package's ``lane_layout_cat``."""
    return category(group_mask(groups, o, d, aabbs), len(groups)).int()


def category(mask, n_groups: int) -> torch.Tensor:
    """The categories C-1-mask of the uint8 masks ``mask``, uint8."""
    return (1 << n_groups) - 1 - mask


def check_mask(kernel: str, mask, groups, n: int) -> None:
    """Raise unless the partitioned form's arguments agree: a mask needs
    groups, and it is uint8 [n]."""
    if mask is None:
        return
    if not groups:
        raise ValueError(f"{kernel}: a lane mask without partition groups")
    if mask.dtype != torch.uint8 or tuple(mask.shape) != (n,):
        raise ValueError(f"{kernel}: mask must be uint8 [{n}], got "
                         f"{mask.dtype} {tuple(mask.shape)}")


def group_bounds(groups) -> list:
    """The sweep kernels' group arguments: start and end of each of at
    most ``MAX_GROUPS`` groups, zeros for a group that is not there."""
    if len(groups) > MAX_GROUPS:
        raise ValueError(f"{len(groups)} partition groups; the kernels "
                         f"take at most {MAX_GROUPS}")
    flat = [c for g in groups for c in (g.start, g.end)]
    return flat + [0] * (2 * MAX_GROUPS - len(flat))


def saved_frac(counts, groups, n_prims: int) -> float:
    """The share of a sweep's pairs that a partitioned bounce skips, from
    its lanes' counts per category (``counts`` [C]): each group's share of
    the primitives times the share of lanes outside it.  The JAX
    package's ``schedule_from_cat_counts.saved_frac``."""
    C = len(counts)
    G = len(groups)
    tot = int(np.sum(counts))
    if tot == 0:
        return 0.0
    s = 0.0
    for i, g in enumerate(groups):
        in_rows = sum(int(counts[p]) for p in range(C)
                      if ((C - 1 - p) >> (G - 1 - i)) & 1)
        s += ((g.end - g.start) / n_prims) * (1.0 - in_rows / tot)
    return s


def worth(counts, groups, n_prims: int) -> bool:
    """Whether a bounce whose lanes have these category counts runs
    partitioned: the scene has groups, the wavefront has at least
    ``PART_MIN_LANES`` lanes and the bounce skips at least
    ``PART_SAVED_MIN`` of the pairs.  The JAX package's
    ``schedule_from_cat_counts.worth``."""
    tot = int(np.sum(counts))
    return (len(groups) > 0 and tot >= PART_MIN_LANES
            and saved_frac(counts, groups, n_prims) >= PART_SAVED_MIN)
