"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Builds the port's CUDA kernels from the checkout (in parallel, beside the
sweep folds' instruction-count probes), holds each against its
plain-PyTorch version on the card (the forward kernels and the gathers'
segmented sum K3 bit for bit, the noise branch's backward K2b to
rounding), renders the committed goldens through them, and drives the
main paths through the entry points a user calls: the CLI's default
workload (`random`, 1280x720, 100 spp, depth 10; sphere sweep K1), the
bench workload (`final`, 400x225, 16 spp, depth 10; typed sweep K1b and
the fused shading K6, the noise texture's marble inside it), and the
adam train step at bench_grad.py's workload (400x225, 8 spp, depth 8:
`random` through K1 and K3, `final` through K1b, K2, K2b and K3;
`random` at depth 50 with remat through the train CLI), whose gradients
it holds against the port's CPU gradients and against themselves: two
steps from one restored state give bit-equal gradients on `random`,
`final` and `earth`, and it times what K3 costs a train step against
``index_add_``.  BVH mode
(phases 18-19): the traversal kernel K4 against its plain version on
every scene kind, leaf size and bounce, and on rays built to meet the
slab test's 0 * inf, timed beside the sweeps on the same rays and on
bounces 0-2 of a full chunk of `sphereflake`'s CLI default; then
`sphereflake` (66,431 spheres) through the CLI at its defaults with
``--intersector bvh``, its render profiled by layer (K4 by bounce), the
BVH's images against the sweeps', and the reference scenes still traced
by the sweeps under auto.  Training through the BVH (phase 20):
`sphereflake`'s train step at bench_grad.py's shape through K4, K4 bit-
equal to its plain walk on the leaf records of the stepped parameters
(and on `three-spheres`, whose geometry the steps move), two steps from
one state bit-equal, card against CPU gradients on `sphereflake-small`.
The silhouette term (phase 21): a train step with the edge-sampled
correction on `cornell` at examples/inverse_geometry.py's shape (K1b)
and on `random` at bench_grad.py's (K1), with and without it, its probe
rays by family, K1 and K1b bit-equal to their plain versions on the
probes, two silhouette steps from one state bit-equal, and card against
CPU correction gradients on `cornell` and `three-spheres`.  The
operations (phase 22), through the CLI at its default workload: walls
with and without ``--checkpoint``, a render killed in a child process
after its first snapshot and resumed byte-equal to the uninterrupted
PNG, ``--preview``'s writes, one ``--watch`` re-render and one
``--profile`` trace naming K1.  The four fits of
``hyper_ray_tracer_tpu_torch.examples`` at their own defaults (phase
23), each passing its own exit criterion.  Cluster mode (phase 24):
the cluster sweep K5 bit-equal to its plain version on `sphereflake`'s
camera rays (timed in raster and in block order beside K4 and K1), on
bounces 0-2 of a full chunk of its CLI default (timed in launch order
and in the render's coherence order, where every ray's hit must be the
same), on `final`, `random` and sphereflake(3), and on a run of 4,096
clusters and on its first 1,000 (a ragged last window);
`sphereflake` through the CLI at its defaults with ``--intersector
cluster`` (its PNG against phase 19's BVH-mode PNG, its render profiled
by layer with K5 by bounce, the native and the NumPy BVH build and
``build_clusters`` timed), two goldens, the bench
workload on `final` in cluster mode against phase 9's PNG, and a
cluster-mode train step on `final` (two steps bit-equal, card against
CPU gradients with the pads excluded).  The partitioned sweep (phase
25): K1b's masked form on `final`'s bench chunk (bounces 0-2) and K1's
on `sphereflake`'s camera rays and their bounce 1 in sweep mode, each in
launch and in category order, bit-equal to its twin and to the unmasked
kernel, timed all three ways beside the pairs each folds and its bound;
`sphereflake` rendered in sweep mode with and without the partition;
`final`'s bench and the CLI default through the CLI with and without
``--no-partition`` (PNGs byte-equal; which bounces partitioned and the
probe's category counts), `final`'s render profiled by layer both ways;
the train CLI on `final` at bench_grad.py's shape both ways (the losses
bit-equal), two partitioned steps from one state, and card against CPU
gradients of a partitioned step.  With the partition on by default,
phases 4, 8, 9 and 12-13 run through it too.  Multi-GPU (phase 26,
``hyper_ray_tracer_tpu_torch/parallel/``, ranks spawned with
``torch.multiprocessing`` that load the kernels built here): the CLI
default through the sharded renderer in a group of one under nccl,
byte-equal to ``render_image``; two ranks on the card under gloo
rendering the CLI default, the bench workload and `sphereflake` in
cluster mode on a rays mesh (byte-equal) and the CLI default on an spp
mesh (within 2e-6, byte-equal run to run); the sharded train step
(losses and gradients against the single process's, the ranks'
parameters bit-equal after two steps); on a machine with several cards,
nccl across up to four of them and the scaling points.  K1b's bf16 form
(phase 27, ``RenderSettings.bf16_hits``): bit-equal to its twin on the
camera rays of `three-spheres`, `final`'s bench and `sphereflake` in
sweep mode, masked too, its MUFU square root equal to the correctly
rounded one on every non-negative bf16 value, its own kernel's ptxas
report free of spills, its pair loop's SASS free of fused HFMA2 and of
FFMAs but the dots' (which add exact products), with its unpacks
counted, timed beside K1b float32 and K1 on `sphereflake`'s camera
rays with the share of pairs whose bf16 discriminant is >= 0, the
images' drift against float32, `sphereflake`'s mean radiance both
ways, and F6's repair (the card's camera rays bit-equal to the
CPU's).  The fused shading K6 (phase 28, ``ops/shade.py``): bit-equal
to the eager ``render.shade_hits`` on bounces 0-2 of a CLI chunk of
`final` and of `sphereflake`, timed beside it and its byte bound.  Each
phase prints one line, with its seconds; any failure ends the run with
a non-zero exit.
The last three lines are the card's name and power limit (nvidia-smi),
one JSON object with a record per kernel, and
``{"ok": true, "device": {...}}``.

``--parent DIR`` (a checkout of an earlier commit, e.g. a ``git
archive`` of the parent) makes phase 15 build that checkout's K3 design
(``csrc/segment_sum.cu`` with torch.sort around it) and time it in turns
with this one on the same inputs; the kernels line's ``parent_ms`` is
then that time, else null.  ``--only-parallel`` builds the kernels and
runs phase 26 alone, without the result lines; ``--only-bf16`` phase
27 alone, ``--only-shade`` phase 28 alone.

Exits non-zero without a result when no CUDA device is available, and
when the port's package is not beside this script.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
BIG = float(np.float32(3.0e38))
T_MIN = 1.0e-3
KERNELS = ("sphere_sweep", "typed_sweep", "turbulence", "segment_sum",
           "bvh_traverse", "cluster_sweep", "shade")
PROBES = "sweep_probe"  # K1b's segment folds one per kernel, never launched

# H100 SXM peaks (NVIDIA's data sheet): HBM at 3.35 TB/s, FP32 outside
# the tensor cores at 67 TFLOP/s (an FMA counted as two operations; the
# kernels round every step on its own, so exact FP32 code can reach half).
HBM_BYTES_S = 3.35e12
FP32_OPS_S = 67e12

# FP32 operations of a sweep, counted from its contract (ops/intersect.py;
# an IEEE division or square root counted as one operation).  The branch a
# pair takes only on a hit (a sphere's roots, a medium's free flight and
# its RNG draw) is left out, so the bound is a floor.  Per ray-primitive
# pair: a sphere or a medium sphere 18 (oc 3, half_b 5, c 6, disc 3, test
# 1; r * r is the sphere's own, once per scene), a rect 12 (t 2, the hit
# point 4, 6 tests), a box or a medium box 25 (6 sub, 6 mul, 10 min/max, 3
# tests); +6 for the center lerp of a sphere that moves (3 mul, 3 add),
# whose factor (time - time0) / (time1 - time0) costs 2 once per ray and
# shutter interval; +33 in a transformed tile (R^T (o - t), R^T d).  Per
# ray, once for every untransformed tile of the types that need it: |d|^2
# (5) of spheres, the 3 slab reciprocals with their floor tests (6) of
# boxes, the 3 dk == 0 tests (3) of rects.  In a transformed tile the
# direction is the pair's own, so these count per pair there.
SWEEP_PAIR_OPS = {"sphere": 18, "rect": 12, "box": 25}
SWEEP_RAY_OPS = {"sphere": 5, "rect": 3, "box": 6}
SWEEP_MOTION_OPS, SWEEP_SHUTTER_OPS, SWEEP_XFORM_OPS = 6, 2, 33
# The SASS opcodes counted as operations (cuobjdump -sass of the built
# library; an FFMA counts as two FP32 operations, IMAD.MOV is a move and
# is not counted).
SASS_FP32 = {"FADD": 1, "FMUL": 1, "FFMA": 2, "FMNMX": 1, "FSETP": 1,
             "FSEL": 1, "FSET": 1, "FCHK": 1, "FRND": 1, "MUFU": 1}
SASS_INT = {"IADD3", "IADD", "VIADD", "IMAD", "LOP3", "SHF", "LEA", "PRMT",
            "ISETP", "IMNMX", "VIMNMX", "SEL", "IABS", "BMSK", "SGXT",
            "POPC", "FLO", "BREV", "I2F", "I2FP", "F2I", "F2IP"}
# K1b's tile kinds as probe instantiations (csrc/sweep_probe.cu): label,
# PT_* tag, transformed, motion.  An untransformed tile's pair loop folds
# one record into the whole packet per trip, a transformed tile's into one
# ray (typed_sweep.cu fold_segment).
PROBE_KINDS = (("sphere", 0, 0, 0), ("motion tile (two copies)", 0, 0, 1),
               ("rect", 1, 0, 0), ("box", 4, 0, 0), ("medium sphere", 2, 0, 0),
               ("medium box", 3, 0, 0), ("transformed box", 4, 1, 0))
# FP32 operations of the noise texture's marble, counted from its
# contract in table form (ops/perlin.py noise, ops/turbulence.py), a sine
# counted as one.  Per octave, 96: the point at 2^k (3 mul), floor (3),
# fraction (3 sub), smoothing (4 per axis: u*u, 2u, 3-2u, product), the
# corner factors 1 - s and s - 1 (6), the lerp weights (4 products of the
# x and y factors, 8 with z), per corner a 3-term dot (3 mul, 2 add) and
# its term (1 mul) (48), the corners' sum (7 add), the octave's weight
# 0.5^k (1 mul) and the octaves' sum (1 add).  Per noise lane, 8 more:
# scale * point (3), then 10 * turb, z + it, sin, 1 + it, 0.5 * it.  The
# permutations and gradients are table lookups, not operations.
TURB_OCTAVES = 7  # csrc/turbulence.cu kDepth, the octave loop's trip count
TURB_OCTAVE_OPS, TURB_LANE_OPS = 96, 8
TURB_OPS = TURB_OCTAVES * TURB_OCTAVE_OPS + TURB_LANE_OPS
# FP32 operations of the noise branch's backward (K2b), counted from its
# contract (csrc/turbulence.cu MarbleGrad).  Per octave, 231: the value's
# 96 again (the turbulence sum's sign is the forward's), per corner 15 for
# the gradient of its term (the three products of two lerp factors with
# the weight-vector dot, 6; the lerp weight times each gradient
# component, 3; the signed sums, 3; the accumulation, 3), per axis 4 for
# the smoothing's slope 6u(1 - u) and the chain, and 3 to sum the octave's
# gradient.  Per noise lane, 26: scale * point (3), the marble's argument
# (2), its cosine and the 0.5 and cotangent-sum factors (3), the
# cotangent's sum (2), the sign (1), the three components of dm/dsp (7),
# grad_point (3), grad_scale (5).
TURB_BWD_OCTAVE_OPS, TURB_BWD_LANE_OPS = 231, 26
TURB_BWD_OPS = TURB_OCTAVES * TURB_BWD_OCTAVE_OPS + TURB_BWD_LANE_OPS
# The same with K2's saved forward, the contract K2b has had since its
# redesign: the turbulence sum S comes saved, so an octave is its
# gradient alone, 198: the point at 2^k (3), floor (3), fraction (3),
# smoothing (12), the corner factors 1 - s and s - 1 (6), the products of
# two lerp factors (12), per corner 18 (its weight-vector dot 5, its lerp
# weight 1, per axis 4: a pair product times the dot, its signed sum,
# the lerp weight times the gradient component, its sum), per axis 4 for
# the slope 6u(1 - u) and the chain, and 3 to sum the octave's gradient.
# Per noise lane the same 26 as above.  Bytes: every lane's flag (a bit),
# cotangent (12) and outputs (28); a noise lane's scale, point and S
# (20).
TURB_SLOPE_OCTAVE_OPS = 198
TURB_SLOPE_OPS = TURB_OCTAVES * TURB_SLOPE_OCTAVE_OPS + TURB_BWD_LANE_OPS
# K2b against autograd through the plain marble: grad_value is a copy and
# must be bit-equal; grad_point and grad_scale sum each octave's analytic
# derivative where autograd chains every operation, so they agree to
# rounding: 1e-4 of each output's largest magnitude.
K2B_SHARE = 1e-4
# Card gradients against the CPU's (every parameter key, the norm of the
# difference over the norm of the CPU's gradient): the kernels equal their
# plain versions and both devices' roots are correctly rounded, so only
# float32 rounding elsewhere (reduction orders, transcendentals) and
# K2b's separate them on `three-spheres`: at most 5.44e-5 measured on an
# H100 (PERF.md), bound the 1-2-5 step at least 3x that; on
# `final` an ulp can also flip a fog or winner decision on a lane, which
# moves its whole sample (7.11e-3 measured).
CARD_GRAD_SHARE = {"three-spheres": 2e-4, "final": 5e-2}


_PHASE_CLOCK = [time.monotonic()]


def phase(n, msg):
    """Print phase ``n``'s line with the seconds since the previous
    phase's line (phase 1's: since the script started)."""
    now = time.monotonic()
    print(f"[phase {n}] ({now - _PHASE_CLOCK[0]:.1f} s) {msg}", flush=True)
    _PHASE_CLOCK[0] = now


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def sweep_rules(label, t_k, b_k, t_p, b_p, active):
    """The sweeps' contract: the kernel's winners and t's equal the plain
    version's bit for bit, and inactive rays are at (BIG, -1).  Returns
    (winner agreement, bit-equal share, max |dt| on matched hits), printed
    beside tests/test_pallas_sweep.py's looser rule (agreement > 0.999)."""
    match = b_k == b_p
    agree = match.float().mean().item()
    exact = (match & (t_k == t_p)).float().mean().item()
    hit = match & (b_p >= 0)
    err = (t_k[hit] - t_p[hit]).abs().max().item() if hit.any() else 0.0
    assert torch.equal(b_k, b_p) and torch.equal(t_k, t_p), \
        f"{label}: not bit-equal (agreement {agree:.6f}, exact {exact:.6f})"
    off = ~active
    assert (b_k[off] == -1).all() and (t_k[off] == BIG).all(), \
        f"{label}: an inactive ray did not return (BIG, -1)"
    return agree, exact, err


def time_ms(fn, args, reps):
    fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, args, reps, only=None):
    """Mean device time per call of the kernels ``fn`` launches: their
    durations in a torch.profiler trace of ``reps`` calls (with ``only``,
    of the kernels whose names contain one of those strings).
    Back-to-back calls timed by events include the host's launch time
    when it exceeds the kernels'; this does not.  Every call launches the
    same kernels, so each name appears k * ``reps`` times for some k.
    The H100's profiler may drop a trace's first kernel, and now and then
    every kernel: a name one short of k * ``reps`` counts k times at the
    mean of those it has; a trace short of more is taken again, and after
    three the calls are timed one by one by CUDA events around each (the
    host's gaps between a call's own kernels then count), or, with
    ``only``, not at all (nan), and that is printed."""
    from collections import Counter

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn(*args)
            torch.cuda.synchronize()
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                and (only is None or any(o in e.name for o in only))]
        names = Counter(e.name for e in kern)
        per_call = {k: max(1, round(c / reps)) for k, c in names.items()}
        if kern and all(0 <= per_call[k] * reps - c <= 1
                        for k, c in names.items()):
            return sum(e.time_range.elapsed_us() * per_call[e.name]
                       / names[e.name] for e in kern) / 1e3
    print(f"device_ms: the profiler lost kernel events of "
          f"{getattr(fn, '__name__', fn)}{'' if only is None else only} "
          f"({dict(names)} in {reps} calls) three times; "
          + ("not measured" if only else "timed call by call by CUDA "
             "events"), flush=True)
    if only is not None:
        return float("nan")
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in pairs:
        start.record()
        fn(*args)
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def kernel_split(fn, args, reps):
    """What one call of ``fn`` runs on the device: {name: (launches a
    call, device ms a call)} for every kernel and memset in a
    torch.profiler trace of ``reps`` calls, the names as the profiler
    gives them.  A trace whose counts are not whole multiples of ``reps``
    (the profiler dropped events) is taken again, up to three times;
    after that the counts are rounded and that is printed."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(*args)
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn(*args)
            torch.cuda.synchronize()
        got = defaultdict(lambda: [0, 0.0])
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                got[e.name][0] += 1
                got[e.name][1] += e.time_range.elapsed_us()
        if got and all(c % reps == 0 for c, _ in got.values()):
            break
    else:
        print(f"kernel_split: event counts {dict(got)} are not multiples "
              f"of {reps} calls three times; rounded", flush=True)
    return {name: (round(c / reps), us / reps / 1e3)
            for name, (c, us) in got.items()}


def split_text(split):
    """``kernel_split``'s result on one line, each name cut to 60
    characters: launches a call and device ms a call."""
    return ", ".join(f"{name[:60]} x{k} {ms:.4f} ms"
                     for name, (k, ms) in sorted(split.items(),
                                                 key=lambda kv: -kv[1][1]))


def in_turns(plain, kernel, args, plain_reps, kernel_reps):
    """Mean times of (plain, kernel, kernel, plain) turns on one card."""
    p1 = time_ms(plain, args, plain_reps)
    k1 = time_ms(kernel, args, kernel_reps)
    k2 = time_ms(kernel, args, kernel_reps)
    p2 = time_ms(plain, args, plain_reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(n_bytes, fp_ops):
    """(bound_ms, bound_by): the larger of the memory time and the FP32
    time of the work."""
    times = {"bytes": n_bytes / HBM_BYTES_S, "operations": fp_ops / FP32_OPS_S}
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def sweep_fp_ops(sw, kinds):
    """FP32 operations per ray of a sweep over the plan of ``sw`` (a
    SweepScene), by the SWEEP_* counts; ``kinds`` maps each PT_* tag to
    "sphere", "rect" or "box".  The spheres that move are those of a
    motion tile whose record names a shutter slot (ops/sphere_sweep.py
    sphere_records)."""
    slot = sw.aux[:, 3].contiguous().view(torch.int32).cpu()
    ops, per_ray, slots = 0, {}, set()
    for tile in sw.plan:
        kind = kinds[tile.ptype]
        ops += tile.width * SWEEP_PAIR_OPS[kind]
        if tile.xform:
            ops += tile.width * (SWEEP_XFORM_OPS + SWEEP_RAY_OPS[kind])
        else:
            per_ray[kind] = SWEEP_RAY_OPS[kind]
        if tile.motion:
            s = slot[tile.start:tile.start + tile.width]
            ops += SWEEP_MOTION_OPS * int((s >= 0).sum())
            slots |= set(s[s >= 0].tolist())
    return ops + sum(per_ray.values()) + SWEEP_SHUTTER_OPS * len(slots)


def sass_pair_ops(sass, kernel, rays, opcodes=None, lines=None):
    """Instructions per ray-primitive pair of the pair loop of the function
    whose name contains ``kernel`` in the SASS text ``sass``: its innermost
    loop with the most instructions, which folds one record into ``rays``
    rays per trip (the noise texture's: one octave of one lane).  Returns
    per-pair counts of the code every trip issues: ``fp32`` (operations,
    an FFMA counted as two), ``int`` (integer instructions, moves left
    out), ``all`` (every instruction, loads and branches included); and
    ``branch``: all instructions of the blocks a branch inside the loop
    may skip (the roots of a sphere the ray's line meets, a moving
    sphere's lerp, the slow paths of a division).  ``opcodes``: a dict
    that gets each opcode's count in the code every trip issues,
    modifiers included; ``lines``: a list that gets that code's
    instructions as text."""
    func = next(f for f in sass.split("Function : ")[1:]
                if kernel in f.splitlines()[0])
    ins = [(int(a, 16), op) for a, _, op in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", func)]
    branches = [(int(a, 16), int(re.findall(r"0x([0-9a-f]+)", args)[-1], 16))
                for a, op, args in re.findall(
                    r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?(BRA\S*)"
                    r"\s*([^;]*);", func)]
    ends = {}
    for a, t in branches:
        if t < a:
            ends[t] = max(ends.get(t, a), a)
    loops = list(ends.items())
    inner = [(t, e) for t, e in loops if not any(
        (t2, e2) != (t, e) and t <= t2 and e2 <= e for t2, e2 in loops)]

    def size(loop):
        return sum(loop[0] <= a <= loop[1] for a, _ in ins)

    start, end = max(inner, key=size)
    guards = [(a, t) for a, t in branches if start <= a < t <= end]
    out = dict.fromkeys(("fp32", "int", "all", "branch"), 0)
    for a, op in ins:
        if not start <= a <= end or op == "NOP":
            continue
        if any(g < a < t for g, t in guards):
            out["branch"] += 1
            continue
        if opcodes is not None:
            opcodes[op] = opcodes.get(op, 0) + 1
        if lines is not None:
            lines.append(re.search(rf"/\*{a:04x}\*/\s*([^;]*);", func)
                         .group(1).strip())
        base = op.split(".")[0]
        out["fp32"] += SASS_FP32.get(base, 0)
        out["int"] += base in SASS_INT and not op.startswith("IMAD.MOV")
        out["all"] += 1
    return {k: v / rays for k, v in out.items()}


def ptxas_report(log):
    """{kernel<template args>: (registers, shared bytes, spill bytes, stack
    frame bytes)} from an nvcc -Xptxas -v log."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '_ZN?(\w+)'", line)
        if m:
            rest, base = m.group(1), ""
            while rest[:1].isdigit():  # <length><identifier>, nested
                k = len(rest) - len(rest.lstrip("0123456789"))
                n = int(rest[:k])
                base, rest = rest[k:k + n], rest[k + n:]
            targs = re.findall(r"L[ib](\d+)E", rest)
            name = f"{base}<{','.join(targs)}>" if targs else base
            out[name] = [0, 0, 0, 0]
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            out[name][2] += int(m.group(1))
        m = re.search(r"(\d+) bytes stack frame", line)
        if m and name:
            out[name][3] = int(m.group(1))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            out[name][0], out[name][1] = int(m.group(1)), int(m.group(2) or 0)
    return {k: tuple(v) for k, v in out.items()}


def golden_errors(img, golden):
    err = np.abs(img - golden)
    med, mean, outl = (float(np.median(err)), float(err.mean()),
                       float(np.mean(err > 3e-2)))
    # The bounds of tests/test_golden.py:58-61.
    assert med < 1e-3 and mean < 4e-3 and outl < 0.02, (med, mean, outl)
    return med, mean, outl


def project(basis, p, width, height):
    """Pixel (column, row from the top) where the pinhole camera sees
    world point p."""
    q = np.asarray(p, np.float64) - basis.origin
    e1, e2 = basis.horizontal.astype(np.float64), \
        basis.vertical.astype(np.float64)
    e0 = basis.lower_left - basis.origin
    # q = lam * (e0 + s e1 + t e2): solve for (1/lam, s/lam... ) linearly.
    a = np.stack([e0, e1, e2], axis=1).astype(np.float64)
    c0, c1, c2 = np.linalg.solve(a, q)
    s, t = c1 / c0, c2 / c0
    return s * (width - 1), (height - 1) - t * (height - 1)


def k2b_phase(dev, gi, sf, det, tables):
    """K2b, the noise branch's backward, against its plain version
    (autograd through noise_texture_plain) on the inputs of `final`'s
    first bounce (``gi`` the gathered int rows, ``sf`` the shade fields,
    ``det`` the hit detail) for a cotangent from a seed, with the scene's
    noise mask and with every lane noise.  K2 runs with its save first
    (its value, bitmask and turbulence sums held bit for bit to
    noise_texture_saved_plain), then K2b on what it saved.  Asserts the
    K2B_SHARE rule; returns {mask: errors, times, bounds}."""
    from hyper_ray_tracer_tpu_torch.models.scene import TT_NOISE
    from hyper_ray_tracer_tpu_torch.ops.turbulence import (
        noise_texture_grad,
        noise_texture_grad_plain,
        noise_texture_saved,
        noise_texture_saved_plain,
    )

    n = gi.shape[0]
    gen = torch.Generator(device=dev).manual_seed(0)
    grad_out = torch.rand((n, 3), device=dev, generator=gen) - 0.5
    out = {}
    for label, col in (("real mask", gi[:, 5]),
                       ("all-true", torch.full_like(gi[:, 5], TT_NOISE))):
        rows = gi.clone()
        rows[:, 5] = col
        ttype = rows[:, 5]
        noise = ttype == TT_NOISE
        fwd = (ttype, sf.scale, det.point, sf.color1, tables)
        value, saved = noise_texture_saved(*fwd)
        torch.cuda.synchronize()
        value_p, (mask_p, turb_p) = noise_texture_saved_plain(*fwd)
        assert torch.equal(value, value_p), f"K2 with its save ({label})"
        assert torch.equal(saved[0], mask_p), f"K2's bitmask ({label})"
        assert torch.equal(saved[1][noise], turb_p[noise]), \
            f"K2's turbulence sums ({label})"

        def k2b(ttype, *a, saved=saved):  # K2b reads the mask, not ttype
            return noise_texture_grad(*a, saved)

        args = (ttype, sf.scale, det.point, grad_out, tables)
        got = k2b(*args)
        torch.cuda.synchronize()
        ref = noise_texture_grad_plain(*args)
        assert torch.equal(got[2], ref[2]), f"K2b grad_value ({label})"
        errs = {}
        for gname, g, r in zip(("grad_point", "grad_scale", "grad_value"),
                               got, ref):
            diff = (g - r).abs()
            top = r.abs().max().item()
            big = r.abs() > 1e-3 * top
            rel = (diff[big] / r.abs()[big]).max().item() if big.any() \
                else 0.0
            errs[gname] = (diff.max().item(), rel, top)
            assert torch.isfinite(g).all(), f"K2b {gname} ({label})"
            assert diff.max().item() <= K2B_SHARE * top, \
                f"K2b {gname} ({label}): {errs[gname]}"
        ms, plain_ms = in_turns(noise_texture_grad_plain, k2b, args, 3, 20)
        n_noise = int(noise.sum())
        out[label] = dict(
            n=n_noise, errs=errs, ms=device_ms(k2b, args, 20), call_ms=ms,
            plain_ms=plain_ms, save_ms=device_ms(noise_texture_saved, fwd,
                                                 20),
            # The first design's contract: every lane's texture type and
            # cotangent read (16), its three outputs written (28); a noise
            # lane's scale and point (16); the value's octaves again.
            old_bound=bound(n * 44 + n_noise * 16, n_noise * TURB_BWD_OPS),
            bound=bound(-(-n // 32) * 4 + n * 40 + n_noise * 20,
                        n_noise * TURB_SLOPE_OPS))
    return out


def k2b_line(k2b, n, ptxas_note, sass):
    return (f"K2 with its save, then noise_texture_grad (K2b) on what it "
            f"saved, vs the plain versions at N={n}: K2's value, bitmask "
            f"and turbulence sums bit-equal, K2b's grad_value bit-equal, "
            f"grad_point and grad_scale within {K2B_SHARE} of their largest "
            "magnitude (asserted): " + "; ".join(
                f"{label} ({v['n']} noise lanes): " + ", ".join(
                    f"{g} max abs err {e[0]:.3e} (max |plain| {e[2]:.3e}), "
                    f"max rel err {e[1]:.3e}" for g, e in v["errs"].items())
                + f"; K2b {v['ms']:.4f} ms on the device "
                f"({v['call_ms']:.4f} ms a call back to back), plain "
                f"{v['plain_ms']:.4f} ms, bound {v['bound'][0]:.6f} ms "
                f"({v['bound'][1]}; the saved-forward contract), "
                f"{v['bound'][0] / v['ms']:.3f} of it; against the first "
                f"design's bound {v['old_bound'][0]:.6f} ms "
                f"({v['old_bound'][1]}) {v['old_bound'][0] / v['ms']:.3f}; "
                f"K2 with its save {v['save_ms']:.4f} ms on the device"
                for label, v in k2b.items())
            + f"; contract {TURB_SLOPE_OPS} FP32 operations per noise lane "
            f"({TURB_BWD_OPS} in the first design's); SASS of K2b's octave "
            f"loop per trip: {sass['fp32']:.0f} FP32 operations (an FFMA "
            f"two), {sass['all']:.0f} issued, {sass['branch']:.0f} more on "
            f"branches; ptxas: {ptxas_note}")


def k3_cases(dev, shape):
    """Phase 15's inputs, the gathers of a train step at ``shape`` (W, H,
    spp) on its first bounce: the winner's rows on `random` and `final`,
    and `final`'s texels (rows of 3, one for every texel of its images).
    Returns {label: (the gathered table's rows, its width, the lanes'
    rows)}."""
    from hyper_ray_tracer_tpu_torch import build_scene
    from hyper_ray_tracer_tpu_torch.camera import make_basis
    from hyper_ray_tracer_tpu_torch.ops import rng as prng
    from hyper_ray_tracer_tpu_torch.ops.intersect import (
        gather_prim_shade_packed,
        hit_detail,
    )
    from hyper_ray_tracer_tpu_torch.ops.textures import texel_rows
    from hyper_ray_tracer_tpu_torch.render import init_state, trace
    from hyper_ray_tracer_tpu_torch.scene_tensors import to_device

    W, H, spp = shape
    pix = torch.arange(W * H, dtype=torch.int64, device=dev).repeat(spp)
    sample = torch.arange(spp, dtype=torch.int64,
                          device=dev).repeat_interleave(W * H)
    cases = {}
    for name in ("random", "final"):
        scene = build_scene(name)
        st = to_device(scene.arrays, scene.static, dev)
        cam = init_state(make_basis(scene.camera, W, H), W, H, pix, sample,
                         0)
        t_hit, prim = trace(st, cam, prng.bounce_base(cam.base, 0))
        pidx = torch.clamp(prim, min=0).long()
        cases[name] = (st.fpack.shape[0], st.fpack.shape[1], pidx)
    pf, sf = gather_prim_shade_packed(st.fpack, st.ipack, pidx,
                                      scene.static)
    det = hit_detail(pf, cam.o, cam.d, cam.time,
                     torch.where(prim >= 0, t_hit, 1.0), scene.static)
    ni, ih, iw, _ = st.tables.images.shape
    cases["final texels"] = (ni * ih * iw, 3,
                             texel_rows(sf, det, st.tables))
    return cases


def parent_k3(dev, parent):
    """The parent design of K3, from a checkout of it at ``parent`` (its
    csrc/segment_sum.cu: torch.sort, then chunk_pieces and row_totals,
    each chunk's pieces and each row's chunk sums added in order), built
    with the port's nvcc flags into build/kernels/parent/ and wrapped as
    its own wrapper did.  Timed beside the shipped K3, never shipped."""
    import ctypes

    from hyper_ray_tracer_tpu_torch.utils import cuda_build

    src_cu = (Path(parent) / "hyper_ray_tracer_tpu_torch" / "csrc"
              / "segment_sum.cu")
    lib = cuda_build.BUILD_DIR / "parent" / "libsegment_sum.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, "-o",
                    str(lib), str(src_cu)], check=True, capture_output=True,
                   timeout=600)
    fn = ctypes.CDLL(str(lib)).hrt_segment_sum
    ptr, c_int = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr, ptr, ptr, c_int, c_int, c_int, ptr, ptr, ptr, ptr]
    fn.restype = c_int

    def segment_sum_parent(src, idx, n_rows):
        n, f = src.shape
        out = torch.empty((n_rows, f), device=dev)
        rows, order = torch.sort(idx.to(torch.int32), stable=True)
        heads = torch.empty((-(-n // 256), f), device=dev)
        bounds = torch.zeros((2, n_rows), dtype=torch.int32, device=dev)
        cuda_build.launch("segment_sum (parent)", fn, dev, order.data_ptr(),
                          rows.data_ptr(), src.data_ptr(), n, f, n_rows,
                          heads.data_ptr(), bounds.data_ptr(),
                          out.data_ptr(), tag="K3.parent", lanes=n)
        return out

    return segment_sum_parent


def k3_phase(dev, cases, parent=None):
    """K3 (``segment_sum``) against its plain version, bit for bit, and
    against ``index_add_``, the PyTorch call it replaces, at the gathers
    of a train step (``k3_cases``).  Cotangents from a seed.  What a call
    runs on the device, kernel by kernel (asserted: at most 4 launches,
    none of them a sort).  With ``parent`` (``parent_k3``), the parent
    design on the same inputs, in turns parent, K3, K3, parent, device
    time by the profiler; its sums held to the float64 sum's rounding
    bound.  Returns {label: measurements}."""
    from hyper_ray_tracer_tpu_torch.ops.gather import (
        segment_sum,
        segment_sum_plain,
    )

    def index_add(src, idx, n_rows):
        return torch.zeros((n_rows, src.shape[1]), device=dev).index_add_(
            0, idx, src)

    out = {}
    for label, (n_rows, f, idx) in cases.items():
        gen = torch.Generator(device=dev).manual_seed(1)
        src = torch.randn((idx.numel(), f), device=dev, generator=gen)
        args = (src, idx, n_rows)
        got = segment_sum(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, segment_sum_plain(*args)), f"K3 ({label})"
        assert torch.equal(segment_sum(*args), got), f"K3 twice ({label})"
        adds = [index_add(*args) for _ in range(5)]
        ms, plain_ms = in_turns(segment_sum_plain, segment_sum, args, 2, 20)
        split = kernel_split(segment_sum, args, 20)
        launches = sum(k for k, _ in split.values())
        assert launches <= 4, f"K3 ({label}): {launches} launches a call"
        # K3's own kernels and the wrapper's fill, nothing of torch.sort
        assert all(any(k in name for k in ("sort_lanes", "reduce_rows",
                                           "combine_levels", "FillFunctor"))
                   for name in split), split
        n = idx.numel()
        v = out[label] = dict(
            n=n, rows=n_rows, f=f, top=int(torch.bincount(idx).max()),
            differ=sum(not torch.equal(a, adds[0]) for a in adds[1:]),
            add_err=max((a - got).abs().max().item() for a in adds),
            ms=device_ms(segment_sum, args, 20), split=split,
            launches=launches, call_ms=ms, plain_ms=plain_ms,
            library_ms=device_ms(index_add, args, 20),
            library_call_ms=time_ms(index_add, args, 20),
            # The cotangent rows read once, the int64 lane rows read once,
            # the gradient written once; one addition an element.
            bound=bound(n * f * 4 + n * 8 + n_rows * f * 4, n * f))
        if parent is not None:
            ref = torch.zeros((n_rows, f), dtype=torch.float64,
                              device=dev).index_add_(0, idx, src.double())
            mag = torch.zeros((n_rows, f), dtype=torch.float64,
                              device=dev).index_add_(0, idx,
                                                     src.double().abs())
            count = torch.bincount(idx, minlength=n_rows).double()[:, None]
            eps = float(np.finfo(np.float32).eps)
            for fn in (parent, segment_sum):
                assert ((fn(*args).double() - ref).abs()
                        <= count * eps * mag).all(), (label, fn)
            p1 = device_ms(parent, args, 20)
            k1 = device_ms(segment_sum, args, 20)
            k2 = device_ms(segment_sum, args, 20)
            p2 = device_ms(parent, args, 20)
            v.update(turns=(p1, k1, k2, p2), parent_ms=(p1 + p2) / 2,
                     turn_ms=(k1 + k2) / 2,
                     parent_split=kernel_split(parent, args, 20))
    return out


def k3_line(k3, ptxas_note):
    def parent(v):
        if "turns" not in v:
            return "parent design not given (--parent)"
        p1, k1, k2, p2 = v["turns"]
        return (f"in turns with the parent design on the same inputs "
                f"(parent, K3, K3, parent): {p1:.4f}, {k1:.4f}, {k2:.4f}, "
                f"{p2:.4f} ms, K3 {v['parent_ms'] / v['turn_ms']:.2f}x "
                f"faster; the parent's call: "
                f"{sum(k for k, _ in v['parent_split'].values())} launches: "
                f"{split_text(v['parent_split'])}")

    return ("segment_sum (K3) vs its plain version at the gathers of a "
            "train step (bench_grad.py's 400x225x8, first bounce), "
            "bit-equal and equal to itself twice (asserted): " + "; ".join(
                f"{label} ({v['n']} lanes into {v['rows']} rows of "
                f"{v['f']}, the largest row {v['top']} lanes): K3 "
                f"{v['ms']:.4f} ms on the device "
                f"({v['call_ms']:.4f} ms a call back to back; "
                f"{v['launches']} launches a call (asserted <= 4, K3's own "
                f"and a fill): "
                f"{split_text(v['split'])}), plain {v['plain_ms']:.4f} ms, "
                f"index_add_ {v['library_ms']:.4f} ms on the device "
                f"({v['library_call_ms']:.4f} ms a call); 4 more index_add_ "
                f"calls on the same inputs: {v['differ']} differ from the "
                f"first in some bit, max |index_add_ - K3| "
                f"{v['add_err']:.3e}; bound {v['bound'][0]:.6f} ms "
                f"({v['bound'][1]}), {v['bound'][0] / v['ms']:.3f} of it; "
                + parent(v)
                for label, v in k3.items())
            + f"; ptxas: {ptxas_note}")


def k3_step_cost(scene, dev, shape, rounds=1, steps=5):
    """K3's cost in a train step: the step as it ships against the same
    step with the gathers' backward through ``index_add_``
    (``gather_rows`` swapped for ``index_select`` in ``ops/intersect``
    and ``ops/textures`` for a turn, then put back), in turns K3,
    index_add_, index_add_, K3, ``rounds`` times.  A turn is the best
    wall of ``steps`` steps, each from one state restored outside the
    timer.  Returns {"K3": [s, ...], "index_add_": [s, ...]}."""
    from hyper_ray_tracer_tpu_torch.camera import make_basis
    from hyper_ray_tracer_tpu_torch.ops import intersect, textures
    from hyper_ray_tracer_tpu_torch.scene_tensors import to_device
    from hyper_ray_tracer_tpu_torch.train import (
        make_train_step,
        pixel_lanes,
        restore,
        snapshot,
    )

    W, H, spp, depth = shape
    st = to_device(scene.arrays, scene.static, dev)
    init, step = make_train_step(scene, W, H, depth)
    state = init(st)
    start = snapshot(state)
    args = (st, make_basis(scene.camera, W, H), *pixel_lanes(W, H, spp, dev),
            0, torch.zeros((W * H, 3), device=dev))
    shipped = intersect.gather_rows
    gathers = {"K3": shipped,
               "index_add_": lambda table, idx: table.index_select(0, idx)}

    def turn(label):
        nonlocal state
        intersect.gather_rows = textures.gather_rows = gathers[label]
        try:
            secs = []
            for _ in range(steps):
                restore(state, start)
                torch.cuda.synchronize()
                t0 = time.monotonic()
                state, loss = step(state, *args)
                loss.item()
                secs.append(time.monotonic() - t0)
            return min(secs)
        finally:
            intersect.gather_rows = textures.gather_rows = shipped

    turn("K3"), turn("index_add_")  # warm-up
    out = {"K3": [], "index_add_": []}
    for _ in range(rounds):
        for label in ("K3", "index_add_", "index_add_", "K3"):
            out[label].append(turn(label))
    return out


def k3_cost_line(name, turns):
    k3, add = (sum(turns[k]) / len(turns[k]) for k in ("K3", "index_add_"))
    return (f"{name} K3 " + " / ".join(f"{s:.4f}" for s in turns["K3"])
            + " s, index_add_ " + " / ".join(f"{s:.4f}"
                                            for s in turns["index_add_"])
            + f" s, K3 over index_add_ {k3 / add:.4f} (means)")


def upload(scene, dev, intersector="sweep"):
    """(scene tensors on ``dev`` in ``intersector``'s mode, the mode)."""
    from hyper_ray_tracer_tpu_torch import prepare_scene
    from hyper_ray_tracer_tpu_torch.scene_tensors import to_device

    arrays, bvh, mode = prepare_scene(scene, intersector)
    return to_device(arrays, scene.static, dev, bvh), mode


def determinism_line(scene, dev, shape, intersector="sweep",
                     silhouette=False, partition=False):
    """Two adam train steps from one state (``train.snapshot`` and
    ``train.restore`` around each): the losses and every parameter's
    gradient bit-equal (asserted).  ``partition``: make_train_step's."""
    from hyper_ray_tracer_tpu_torch.camera import make_basis
    from hyper_ray_tracer_tpu_torch.train import (
        make_train_step,
        pixel_lanes,
        restore,
        snapshot,
    )

    W, H, spp, depth = shape
    st, mode = upload(scene, dev, intersector)
    init, step = make_train_step(scene, W, H, depth, mode,
                                 silhouette=silhouette, partition=partition)
    state = init(st)
    start = snapshot(state)
    args = (st, make_basis(scene.camera, W, H), *pixel_lanes(W, H, spp, dev),
            0, torch.zeros((W * H, 3), device=dev))
    runs = []
    for _ in range(2):
        restore(state, start)
        state, loss = step(state, *args)
        runs.append((loss.clone(), {k: p.grad.clone()
                                    for k, p in state.params.items()}))
    (loss_a, g_a), (loss_b, g_b) = runs
    differ = [k for k in g_a if not torch.equal(g_a[k], g_b[k])]
    assert torch.equal(loss_a, loss_b) and not differ, (scene.name, differ)
    if partition:
        assert any(step.schedule().decisions), scene.name
    nonzero = [k for k in g_a if g_a[k].abs().max() > 0]
    return (f"{scene.name}: loss {loss_a.item():.6f} both times, all "
            f"{len(g_a)} gradient keys bit-equal ({len(nonzero)} nonzero: "
            f"{', '.join(nonzero)})")


def loss_and_grads(scene, device, W, H, spp, depth, intersector="sweep",
                   partition=False):
    """The port's loss and every parameter's gradient (zeros where the
    render never reads it), on the CPU, of ``make_loss_fn`` on
    ``device`` against a constant target (``partition``: its flag)."""
    from hyper_ray_tracer_tpu_torch.camera import make_basis
    from hyper_ray_tracer_tpu_torch.train import (
        extract_params,
        make_loss_fn,
        pixel_lanes,
    )

    st, mode = upload(scene, device, intersector)
    params = {k: v.detach().clone().requires_grad_()
              for k, v in extract_params(st.arrays).items()}
    pix, sam = pixel_lanes(W, H, spp, device)
    target = torch.full((W * H, 3), 0.25, device=device)
    loss_fn = make_loss_fn(scene, W, H, depth, mode, partition=partition)
    loss = loss_fn(params, st, make_basis(scene.camera, W, H), pix, sam, 0,
                   target)
    if partition:
        assert any(loss_fn.schedule().decisions), scene.name
    loss.backward()
    return loss.item(), {k: (torch.zeros_like(p) if p.grad is None
                             else p.grad).cpu() for k, p in params.items()}


def card_grad_check(scene, dev, share, shape=(64, 36, 2, 4),
                    intersector="sweep", test_rule=True, partition=False):
    """Every gradient key and the loss on ``dev`` against the CPU's within
    ``share`` (CARD_GRAD_SHARE's rule); returns the phase's text."""
    loss_c, g_c = loss_and_grads(scene, "cpu", *shape, intersector,
                                 partition)
    loss_g, g_g = loss_and_grads(scene, dev, *shape, intersector, partition)
    worst = {}
    for k, ref in g_c.items():
        assert torch.isfinite(g_g[k]).all(), (scene.name, k)
        norm = ref.norm().item()
        err = (g_g[k] - ref).norm().item()
        worst[k] = err / norm if norm else err
        assert err <= share * norm, (scene.name, k, err, norm)
    assert abs(loss_g - loss_c) <= share * abs(loss_c), (loss_g, loss_c)
    text = (f"{scene.name} ({intersector}): loss card {loss_g:.6f} cpu "
            f"{loss_c:.6f}; |card - cpu| / |cpu| by key "
            + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()
                        if g_c[k].abs().max() > 0)
            + f" (bound {share}; the other keys' gradients are 0 on both)")
    if not test_rule:
        return text
    # The rule of tests/test_torch_cuda.py
    # test_train_step_gradients_on_card_match_cpu, at its shape: max
    # |card - cpu| over max |cpu|, by key.
    _, t_c = loss_and_grads(scene, "cpu", 32, 18, 2, 3)
    _, t_g = loss_and_grads(scene, dev, 32, 18, 2, 3)
    test_rule = {k: ((t_g[k] - ref).abs().max() / ref.abs().max()).item()
                 for k, ref in t_c.items() if ref.abs().max() > 0}
    return (text + "; the card test's rule at 32x18 2spp d3, max "
            "|card - cpu| / max "
            "|cpu| by key " + ", ".join(f"{k} {v:.2e}"
                                        for k, v in test_rule.items()))


# bench_grad.py's workload: 400x225, 8 spp, depth 8.
TRAIN_SHAPE = (400, 225, 8, 8)
HAND_FWD = ("sphere_sweep_kernel", "typed_sweep_kernel",
            "noise_texture_kernel", "bvh_traverse_kernel",
            "cluster_sweep_kernel")


def train_run(scene, dev, shape, steps, reset_counts, counts,
              intersector="sweep", silhouette=False, partition=False):
    """Adam train steps through ``make_train_step`` (``partition``: its
    flag): one warm-up, ``steps`` timed (the launch counts set to 0
    before them and read after), then one profiled.  Asserts every gradient finite; returns the times, the
    losses, peak memory, launches, the largest |grad| of each key, the
    profiled step's device time by range, and the state and scene."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from hyper_ray_tracer_tpu_torch.camera import make_basis
    from hyper_ray_tracer_tpu_torch.train import make_train_step, pixel_lanes

    W, H, spp, depth = shape
    st, mode = upload(scene, dev, intersector)
    init, step = make_train_step(scene, W, H, depth, mode,
                                 silhouette=silhouette, partition=partition)
    state = init(st)
    basis = make_basis(scene.camera, W, H)
    pix, sam = pixel_lanes(W, H, spp, dev)
    target = torch.zeros((W * H, 3), device=dev)
    state, loss = step(state, st, basis, pix, sam, 0, target)
    loss.item()  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, secs = [], []
    for _ in range(steps):
        t0 = time.monotonic()
        state, loss = step(state, st, basis, pix, sam, 0, target)
        losses.append(loss.item())
        secs.append(time.monotonic() - t0)
    launched = counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for k, p in state.params.items():
        assert p.grad is not None and torch.isfinite(p.grad).all(), \
            (scene.name, k)
    gmax = {k: p.grad.abs().max().item() for k, p in state.params.items()}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        state, loss = step(state, st, basis, pix, sam, 0, target)
        loss.item()
        wall = (time.monotonic() - t0) * 1e3
    events = prof.events()
    ranges = ("forward", "backward", "optimizer")
    kern = [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.name not in ranges]
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    span = (max(e.time_range.end for e in kern)
            - min(e.time_range.start for e in kern)) / 1e3 if kern else 0.0
    by_range = {r: sum(e.device_time_total for e in events
                       if e.device_type == DeviceType.CPU and e.name == r)
                / 1e3 for r in ("forward", "optimizer", "silhouette")}
    host_ms = {r: sum(e.cpu_time_total for e in events
                      if e.device_type == DeviceType.CPU and e.name == r)
               / 1e3 for r in ("forward", "silhouette")}
    # The backward runs on autograd's device thread, outside the range on
    # the calling thread: it is the busy time the other two leave.  The
    # ctypes-launched forward kernels have no op to link them to their
    # range (phase 8); they all run in the forward pass.
    linked = sum(k.duration for e in events for k in getattr(e, "kernels", ())
                 if any(h in k.name for h in HAND_FWD)) / 1e3
    hand = sum(e.time_range.elapsed_us() for e in kern
               if any(h in e.name for h in HAND_FWD)) / 1e3
    fwd = by_range["forward"] + hand - linked
    opt = by_range["optimizer"]
    by_name = {}
    for e in kern:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    sched = step.schedule()
    return dict(losses=losses, secs=secs, s=min(secs),
                partitioned=([] if sched is None else
                             [b for b, v in enumerate(sched.decisions)
                              if v]),
                mrays=W * H * spp / min(secs) / 1e6, peak=peak_gb,
                launched=launched, gmax=gmax, busy=busy, span=span,
                wall=wall, fwd=fwd, bwd=busy - fwd - opt, opt=opt,
                sil=by_range["silhouette"], host_ms=host_ms,
                kernels=len(kern), top=top, state=state, scene_t=st,
                mode=mode)


def train_line(name, shape, r):
    W, H, spp, depth = shape
    idle = 1 - r["busy"] / r["span"] if r["span"] else float("nan")
    return (f"{name} {W}x{H}x{spp} d{depth}: {r['s']:.4f} s/step (best of "
            f"{len(r['secs'])}: " + ", ".join(f"{x:.4f}" for x in r["secs"])
            + f"), {r['mrays']:.4f} fwd+bwd camera Mrays/s, peak device "
            f"memory {r['peak']:.2f} GB, losses "
            + ", ".join(f"{x:.6f}" for x in r["losses"])
            + f", launches {r['launched']}, bounces partitioned "
            f"{r['partitioned']}; profiled step: {r['kernels']} "
            f"kernels busy {r['busy']:.3f} ms in a {r['span']:.3f} ms span "
            f"(idle {idle:.3f}; busy / wall {r['busy'] / r['wall']:.3f} of "
            f"{r['wall']:.3f} ms), forward {r['fwd']:.3f}, backward "
            f"{r['bwd']:.3f}, optimizer {r['opt']:.3f} ms busy; the kernels "
            "that take most of it: " + "; ".join(
                f"{name[:90]} x{n} {ms:.3f} ms" for name, (ms, n) in r["top"])
            + "; max |grad| "
            "by key " + ", ".join(f"{k} {v:.3e}" for k, v in
                                  r["gmax"].items())
            + (f"; the silhouette range: {r['sil']:.3f} ms busy (the "
               "kernels linked to it; its probes' hand kernels count in "
               f"the forward), {r['host_ms']['silhouette']:.1f} ms on the "
               f"host of the forward's {r['host_ms']['forward']:.1f}"
               if r["host_ms"]["silhouette"] else ""))


# Phases 20-21.  Card against CPU gradients of a silhouette correction,
# at a small shape: 32x18, depth 2, the correction's defaults, d sum(w *
# correction) for weights from a seed, the rule of CARD_GRAD_SHARE (the
# norm of the difference over the norm of the CPU's gradient, by key).
# `cornell`'s segments are closed forms: float32 rounding alone
# separates the devices, as in phase 11 (bound 2e-4).  `three-spheres`'
# hollow shell brings ``_edge_blocked``'s gate (ROADMAP F4): on the
# samples of the shell's own rim the discriminant is ~0, so rounding
# decides which the gate drops, and the devices drop different ones (5
# of 320 on an H100, named in the phase's line); each moves a whole
# sample's weight.  So `three-spheres` is held twice: without its hollow shell
# (``glass_shells=[]``: no gate and no shell family; the ground sphere
# stays a source of every bender), every other family at phase 11's
# 2e-4; with it, 0.2, the 1-2-5 step at least 3x the 5.11e-2 measured
# (H100, PERF.md).
SIL_CARD_SHAPE = (32, 18, 2)
SIL_CARD_SHARE = {"cornell": 2e-4, "three-spheres": 0.2}
SIL_NO_SHELL_SHARE = 2e-4
# Card against CPU train-step gradients on `sphereflake-small`, phase 11's
# shape, in BVH and sweep mode: the pixels none of whose lanes part
# between the devices (``kept_loss_grads``) at phase 11's 2e-4; the whole
# frame at 2e-2, the 1-2-5 step at least 3x the 4.22e-3 measured (H100,
# PERF.md), as `final`'s flips are in CARD_GRAD_SHARE (ROADMAP F5).
# The parting lanes (F6, ROADMAP: each torch call's values of the lanes
# recorded on both devices): four parted from the
# camera ray on, where torch's CUDA division by a Python number
# multiplied by the reciprocal (``render.init_state`` now divides by a
# tensor, ``ops/math.div_rn``); the lane that may still part does so
# through torch's own CUDA rounding of cos, sin and atan2 and of a
# three-term sum(-1) (added (a + c) + b on the card), an ulp that a
# grazing hit on the r = 1000 ground turns into another path.
FLAKE_SMALL_SHARE = 2e-2
FLAKE_KEPT_SHARE = 2e-4
# A lane parts between the devices when its radiance differs by more
# than this (tests/test_torch_render.py's per-lane tolerance).
PART_RAD = 1e-4
# examples/inverse_geometry.py's defaults: cornell, 96x96, 4 spp, depth 4.
SIL_CORNELL_SHAPE = (96, 96, 4, 4)


def correction_grads(scene, device, shape, stats=None, **ids):
    """(image, every parameter's gradient on the CPU) of d sum(w *
    correction) on ``device``, the correction at its defaults (``ids``:
    its id selectors, e.g. ``sphere_ids``)."""
    from hyper_ray_tracer_tpu_torch.camera import make_basis
    from hyper_ray_tracer_tpu_torch.ops.edges import (
        make_silhouette_correction,
    )
    from hyper_ray_tracer_tpu_torch.scene_tensors import (
        bind_params,
        extract_params,
    )

    W, H, depth = shape
    st, _ = upload(scene, device)
    params = {k: v.detach().clone().requires_grad_()
              for k, v in extract_params(st.arrays).items()}
    corr = make_silhouette_correction(scene, W, H, depth, st.host_geom,
                                      **ids)
    img = corr(bind_params(st, params), make_basis(scene.camera, W, H), 7,
               stats)
    wts = torch.from_numpy(np.random.default_rng(3).uniform(
        -1, 1, (W * H, 3)).astype(np.float32)).to(device)
    (img * wts).sum().backward()
    return img, {k: (torch.zeros_like(p) if p.grad is None else p.grad)
                 .cpu() for k, p in params.items()}


def grad_gaps(name, g_c, g_g, share):
    """|card - cpu| / |cpu| by key (the norms), each within ``share``
    (asserted); a key whose CPU gradient is 0 must be 0 on the card."""
    worst = {}
    for k, ref in g_c.items():
        assert torch.isfinite(g_g[k]).all(), (name, k)
        norm = ref.norm().item()
        if norm == 0:
            assert not g_g[k].any(), (name, k)
            continue
        worst[k] = (g_g[k] - ref).norm().item() / norm
        assert worst[k] <= share, (name, k, worst[k])
    return ", ".join(f"{k} {v:.2e}" for k, v in worst.items())


def sil_card_check(scene, dev, share):
    """The correction's gradients on the card against the CPU's within
    ``share`` (SIL_CARD_SHARE's rule); on a scene with hollow shells,
    also without them (no ``_edge_blocked`` gate, no shell family)
    within SIL_NO_SHELL_SHARE; the shell rim samples the gate drops on
    each device, and those it drops on one only (ROADMAP F4)."""
    stats_c, stats_g = {}, {}
    _, g_c = correction_grads(scene, "cpu", SIL_CARD_SHAPE, stats_c)
    img, g_g = correction_grads(scene, dev, SIL_CARD_SHAPE, stats_g)
    assert torch.equal(img, torch.zeros_like(img)), scene.name
    text = (f"{scene.name}: |card - cpu| / |cpu| by key "
            + grad_gaps(scene.name, g_c, g_g, share) + f" (bound {share})")
    if "edge_blocked_own_rim" in stats_c:
        rim_c = set(stats_c["edge_blocked_own_rim"])
        rim_g = set(stats_g["edge_blocked_own_rim"])
        text += (f"; the shell's own rim samples _edge_blocked drops (F4): "
                 f"card {len(rim_g)}, cpu {len(rim_c)} of "
                 f"{stats_c['spheres']['samples']} direct samples; on one "
                 f"device only, as (sphere id, sample): card "
                 f"{sorted(rim_g - rim_c)}, cpu {sorted(rim_c - rim_g)}")
        _, n_c = correction_grads(scene, "cpu", SIL_CARD_SHAPE,
                                  glass_shells=[])
        _, n_g = correction_grads(scene, dev, SIL_CARD_SHAPE,
                                  glass_shells=[])
        text += ("; without the shells |card - cpu| / |cpu| by key "
                 + grad_gaps(scene.name, n_c, n_g, SIL_NO_SHELL_SHARE)
                 + f" (bound {SIL_NO_SHELL_SHARE})")
    return text


def kept_loss_grads(scene, shape, intersector, devs):
    """``loss_and_grads``' loss (a constant 0.25 target) on each of
    ``devs``, over the pixels none of whose lanes part between them: a
    lane parts when its radiance (the differentiable forward's) differs
    by more than PART_RAD.  Returns (every parameter's gradient by
    device, on the CPU; the parting lanes as (pixel, sample, max |card -
    cpu|))."""
    from hyper_ray_tracer_tpu_torch.camera import make_basis
    from hyper_ray_tracer_tpu_torch.render import render_radiance
    from hyper_ray_tracer_tpu_torch.scene_tensors import (
        bind_params,
        extract_params,
    )
    from hyper_ray_tracer_tpu_torch.train import pixel_lanes

    W, H, spp, depth = shape
    runs = {}
    for d in devs:
        st, _ = upload(scene, d, intersector)
        params = {k: v.detach().clone().requires_grad_()
                  for k, v in extract_params(st.arrays).items()}
        pix, sam = pixel_lanes(W, H, spp, d)
        rad = render_radiance(bind_params(st, params), scene.background,
                              make_basis(scene.camera, W, H), W, H,
                              pix.reshape(-1), sam.reshape(-1), 0, depth)
        runs[d] = params, rad
    diff = (runs[devs[0]][1].detach().cpu()
            - runs[devs[1]][1].detach().cpu()).abs().amax(-1)
    lanes = torch.nonzero(diff > PART_RAD).flatten().tolist()
    rows = [(i % (W * H), i // (W * H), float(diff[i])) for i in lanes]
    keep = torch.ones(W * H, dtype=torch.bool)
    keep[[r[0] for r in rows]] = False
    grads = {}
    for d, (params, rad) in runs.items():
        w = keep.to(device=d, dtype=torch.float32)[:, None]
        loss = (((rad.reshape(spp, W * H, 3).mean(0) - 0.25) ** 2)
                * w).sum() / (3 * w.sum())
        loss.backward()
        grads[d] = {k: (torch.zeros_like(p) if p.grad is None else p.grad)
                    .cpu() for k, p in params.items()}
    return grads, rows


def flip_split_check(scene, dev, intersector, shape=(64, 36, 2, 4)):
    """Card against CPU gradients by FLAKE_SMALL_SHARE's rule over the
    whole frame, and by FLAKE_KEPT_SHARE's over the pixels whose lanes
    do not part (``kept_loss_grads``, which names the others)."""
    text = card_grad_check(scene, dev, FLAKE_SMALL_SHARE, shape,
                           intersector, test_rule=False)
    grads, rows = kept_loss_grads(scene, shape, intersector, (dev, "cpu"))
    W, H, spp, _ = shape
    whole = sum(r[2] > 1e-2 for r in rows)
    return (text + f"; lanes whose radiance parts card vs CPU by more than "
            f"{PART_RAD}: {len(rows)} of {W * H * spp} ({whole} by more "
            f"than 1e-2) in {len({r[0] for r in rows})} pixels, as (pixel, "
            "sample, max |card - cpu|): "
            + ", ".join(f"({p}, {s_}, {x:.3g})" for p, s_, x in rows[:12])
            + (" ..." if len(rows) > 12 else "")
            + "; the other pixels' loss |card - cpu| / |cpu| by key "
            + grad_gaps(scene.name, grads["cpu"], grads[dev],
                        FLAKE_KEPT_SHARE)
            + f" (bound {FLAKE_KEPT_SHARE})")


def k4_after_steps(r, scene, dev, shape):
    """K4 against its plain walk on the leaf records ``bind_params`` builds
    from a train run's final parameters (``r``: ``train_run``'s), on
    the camera rays and first bounce of the run's shape: bit-equal
    (asserted).  Returns the rays compared."""
    from hyper_ray_tracer_tpu_torch.camera import make_basis
    from hyper_ray_tracer_tpu_torch.ops import rng as prng
    from hyper_ray_tracer_tpu_torch.ops.bvh import (
        bvh_traverse,
        bvh_traverse_plain,
    )
    from hyper_ray_tracer_tpu_torch.render import bounce_step, init_state
    from hyper_ray_tracer_tpu_torch.scene_tensors import bind_params
    from hyper_ray_tracer_tpu_torch.train import pixel_lanes

    W, H, spp, _ = shape
    with torch.no_grad():
        bound = bind_params(r["scene_t"], r["state"].params)
        pix, sam = pixel_lanes(W, H, spp, dev)
        wave = init_state(make_basis(scene.camera, W, H), W, H,
                          pix.reshape(-1), sam.reshape(-1), 0)
        rays = 0
        for bounce in range(2):
            bb = prng.bounce_base(wave.base, bounce)
            args = (wave.o, wave.d, wave.time, wave.alive, bb)
            t_k, b_k = bvh_traverse(bound.bvh, *args, T_MIN)
            t_p, b_p = bvh_traverse_plain(bound.bvh.tree, bound.bvh.prims,
                                          *args, T_MIN, bound.bvh.static)
            assert torch.equal(t_k, t_p) and torch.equal(b_k, b_p), \
                (scene.name, bounce)
            rays += int(wave.alive.sum())
            wave = bounce_step(bound, scene.background, wave, bounce)
    return rays


def probes_on_plain(scene, dev, shape, kernel, plain, waves_of):
    """The first probe wavefront of a correction on ``dev`` and its
    second bounce, traced by ``kernel`` and by ``plain``: bit-equal
    (asserted).  Returns (probe rays by family, rays compared)."""
    from hyper_ray_tracer_tpu_torch.ops import rng as prng
    from hyper_ray_tracer_tpu_torch.render import bounce_step

    stats = {}
    correction_grads(scene, dev, shape, stats)
    wave = stats["probe_waves"][0]
    st, _ = upload(scene, dev)
    rays = 0
    with torch.no_grad():
        for bounce in range(2):
            bb = prng.bounce_base(wave.base, bounce)
            args = waves_of(st, wave, bb)
            t_k, b_k = kernel(*args)
            t_p, b_p = plain(*args)
            assert torch.equal(t_k, t_p) and torch.equal(b_k, b_p), \
                (scene.name, bounce)
            rays += int(wave.alive.sum())
            wave = bounce_step(st, scene.background, wave, bounce)
    fams = {k: v["probe_rays"] for k, v in stats.items()
            if isinstance(v, dict)}
    return fams, rays


def train_phases(dev, reset_counts, counts, flake, random_train):
    """Phases 20 (a train step through the BVH) and 21 (a silhouette train
    step); returns phase 20's ``train_run``."""
    from hyper_ray_tracer_tpu_torch import build_scene
    from hyper_ray_tracer_tpu_torch.ops.sphere_sweep import (
        sphere_sweep,
        sphere_sweep_plain,
    )
    from hyper_ray_tracer_tpu_torch.ops.typed_sweep import (
        typed_sweep,
        typed_sweep_plain,
    )

    # Phase 20: a train step through the BVH: `sphereflake` at
    # bench_grad.py's shape through K4, the counts set to 0 just before
    # its timed steps and read just after.
    flake_train = train_run(flake, dev, TRAIN_SHAPE, 3, reset_counts,
                            counts, intersector="bvh")
    for kname in ("bvh_traverse", "segment_sum"):
        assert flake_train["launched"][kname] > 0, \
            f"the sphereflake train step missed {kname}"
    assert flake_train["launched"]["sphere_sweep"] == 0, \
        flake_train["launched"]
    assert flake_train["mode"] == "bvh"
    flake_k4_rays = k4_after_steps(flake_train, flake, dev, TRAIN_SHAPE)
    # `sphereflake`'s flat sky leaves its geometry where it is; on
    # `three-spheres` the adam steps move it, and K4 follows.
    moved_shape = (64, 36, 2, 4)
    moved = train_run(build_scene("three-spheres"), dev, moved_shape, 1,
                      reset_counts, counts, intersector="bvh")
    assert moved["gmax"]["geom.p0"] > 0
    moved_k4_rays = k4_after_steps(moved, build_scene("three-spheres"), dev,
                                   moved_shape)
    phase(20, "train step through the BVH " + train_line(
        "sphereflake", TRAIN_SHAPE, flake_train)
        + f" | K4 bit-equal to bvh_traverse_plain on the leaf records of "
        f"the parameters after the steps (asserted): sphereflake "
        f"{flake_k4_rays} rays (camera and first bounce), three-spheres "
        f"64x36x2 d4 after adam steps that moved its geometry "
        f"{moved_k4_rays} rays | two steps from one restored state: "
        + determinism_line(flake, dev, TRAIN_SHAPE, intersector="bvh")
        + " | card vs CPU gradients at 64x36 2spp d4 (asserted): "
        + "; ".join(flip_split_check(build_scene("sphereflake-small"), dev,
                                     mode) for mode in ("bvh", "sweep")))

    # Phase 21: a silhouette train step.  `cornell` at
    # examples/inverse_geometry.py's shape (K1b), with and without the
    # correction; `random` at bench_grad.py's (K1) with it, the step
    # without it being phase 12's.
    cornell = build_scene("cornell")
    sil_cornell = train_run(cornell, dev, SIL_CORNELL_SHAPE, 3,
                            reset_counts, counts, silhouette=True)
    assert sil_cornell["launched"]["typed_sweep"] > 0
    plain_cornell = train_run(cornell, dev, SIL_CORNELL_SHAPE, 3,
                              reset_counts, counts)
    sil_random = train_run(build_scene("random"), dev, TRAIN_SHAPE, 2,
                           reset_counts, counts, silhouette=True)
    for kname in ("sphere_sweep", "segment_sum"):
        assert sil_random["launched"][kname] > 0, kname
    assert sil_cornell["gmax"]["geom.p0"] > 0
    k1_fams, k1_rays = probes_on_plain(
        build_scene("random"), dev, TRAIN_SHAPE[:2] + TRAIN_SHAPE[3:],
        lambda *a: sphere_sweep(*a), lambda *a: sphere_sweep_plain(*a),
        lambda st, w, bb: (*st.spheres, w.o, w.d, w.time, w.alive, T_MIN))
    k1b_fams, k1b_rays = probes_on_plain(
        cornell, dev, SIL_CORNELL_SHAPE[:2] + SIL_CORNELL_SHAPE[3:],
        lambda *a: typed_sweep(*a), lambda *a: typed_sweep_plain(*a),
        lambda st, w, bb: (st.sweep, w.o, w.d, w.time, w.alive, bb, T_MIN))
    phase(21, "silhouette train step " + train_line(
        "cornell", SIL_CORNELL_SHAPE, sil_cornell)
        + f" | without the correction {plain_cornell['s']:.4f} s/step, "
        f"peak {plain_cornell['peak']:.2f} GB | " + train_line(
            "random", TRAIN_SHAPE, sil_random)
        + f" | without it (phase 12) {random_train['s']:.4f} s/step | "
        f"probe rays by family (both sides, all probes): random {k1_fams}, "
        f"cornell {k1b_fams} | K1 bit-equal to sphere_sweep_plain on "
        f"random's first probe wavefront and its next bounce ({k1_rays} "
        f"rays), K1b to typed_sweep_plain on cornell's ({k1b_rays}) "
        "(asserted) | two silhouette steps from one restored state: "
        + determinism_line(cornell, dev, SIL_CORNELL_SHAPE, silhouette=True)
        + "; " + determinism_line(build_scene("random"), dev, TRAIN_SHAPE,
                                  silhouette=True)
        + f" | correction gradients card vs CPU at {SIL_CARD_SHAPE[0]}x"
        f"{SIL_CARD_SHAPE[1]} d{SIL_CARD_SHAPE[2]} (asserted): " + "; ".join(
            sil_card_check(build_scene(name), dev, share)
            for name, share in SIL_CARD_SHARE.items()))

    return flake_train


# Phase 22's chunk: 4 spp, so that the first snapshot (every 8 chunks
# without a preview) holds 32 of the 100 samples.
OPS_CHUNK = 4


def ops_phase(reset_counts, counts):
    """Phase 22: the CLI's operations at its default workload (`random`,
    1280x720, 100 spp, d10; K1): walls with and without --checkpoint in
    turns; a render with --checkpoint killed in a child process after its
    first snapshot, then resumed, byte-equal to the uninterrupted PNG;
    --preview's writes; one --watch re-render on a small override; one
    --profile capture, which must name K1's kernel.  Returns the line."""
    import threading

    from hyper_ray_tracer_tpu_torch import render as render_mod
    from hyper_ray_tracer_tpu_torch.__main__ import main as cli_main
    from hyper_ray_tracer_tpu_torch.utils import checkpoint as ckpt
    from hyper_ray_tracer_tpu_torch.utils import watch as watch_mod
    from hyper_ray_tracer_tpu_torch.utils.image import read_png

    chunk = ["--spp-chunk", str(OPS_CHUNK), "--verbosity", "0"]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        ck = tmp / "r.ckpt"

        def cli(*argv):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            assert cli_main(list(argv)) == 0, argv
            torch.cuda.synchronize()
            return time.monotonic() - t0

        # Walls in turns: without, with, with, without the checkpoint.
        walls = {"plain": [], "checkpoint": []}
        reset_counts()
        for kind in ("plain", "checkpoint", "checkpoint", "plain"):
            extra = []
            if kind == "checkpoint":
                ck.unlink(missing_ok=True)
                extra = ["--checkpoint", str(ck)]
            walls[kind].append(cli("--output", str(tmp / f"{kind}.png"),
                                   *chunk, *extra))
        launched = counts()
        assert launched["sphere_sweep"] > 0, launched
        full = (tmp / "checkpoint.png").read_bytes()
        assert full == (tmp / "plain.png").read_bytes(), \
            "--checkpoint changed the image"
        assert ckpt.load_state(str(ck))[1] == 100

        # Interrupted: a child process killed after its first snapshot.
        ck.unlink()
        child = subprocess.Popen(
            [sys.executable, "-m", "hyper_ray_tracer_tpu_torch", "--output",
             str(tmp / "part.png"), *chunk, "--checkpoint", str(ck)],
            cwd=ROOT)
        try:
            deadline = time.monotonic() + 300
            while not ck.exists() and child.poll() is None:
                assert time.monotonic() < deadline, "no snapshot in 300 s"
                time.sleep(0.005)
        finally:
            child.kill()
            rc = child.wait(timeout=60)
        assert rc != 0, "the child finished before it was killed"
        done = ckpt.load_state(str(ck))[1]
        assert done % (8 * OPS_CHUNK) == 0 and 0 < done < 100, done
        reset_counts()
        resume_wall = cli("--output", str(tmp / "resumed.png"), *chunk,
                          "--checkpoint", str(ck))
        resume_launched = counts()["sphere_sweep"]
        assert (tmp / "resumed.png").read_bytes() == full, \
            "the resumed render differs from the uninterrupted one"

        # --preview at the auto chunk: its writes.
        writes = []
        real_write = render_mod.write_png

        def counting(path, img):
            writes.append(path)
            real_write(path, img)

        render_mod.write_png = counting
        try:
            preview_wall = cli("--output", str(tmp / "pv_out.png"),
                               "--preview", str(tmp / "pv.png"),
                               "--verbosity", "0")
        finally:
            render_mod.write_png = real_write
        assert len(writes) >= 8, writes
        assert (tmp / "pv.png").read_bytes() == \
            (tmp / "pv_out.png").read_bytes()

        # --watch: the default render, then one re-render on an edit.
        params = tmp / "params.json"
        params.write_text("{}")
        out = tmp / "watch.png"
        real_loop = watch_mod.watch_loop

        def one_change(path, on_change, poll_s=0.5, log=None, max_iters=None):
            def once(overrides):
                on_change(overrides)
                raise KeyboardInterrupt  # Ctrl-C after the re-render

            return real_loop(path, once, poll_s=0.05, log=log,
                             max_iters=6000)

        def edit():
            while not out.exists():
                time.sleep(0.05)
            time.sleep(0.2)
            params.write_text('{"width": 320, "height": 180, '
                              '"samples": 4}')

        editor = threading.Thread(target=edit, daemon=True)
        editor.start()
        watch_mod.watch_loop = one_change
        try:
            watch_wall = cli("--output", str(out), "--verbosity", "0",
                             "--watch", str(params))
        finally:
            watch_mod.watch_loop = real_loop
        editor.join(timeout=60)
        watch_shape = read_png(out).shape
        assert watch_shape == (180, 320, 3), watch_shape

        # --profile: one chunk of the default workload.
        logdir = tmp / "prof"
        profile_wall = cli("--output", str(tmp / "prof.png"), "--samples",
                           "9", "--verbosity", "0", "--profile", str(logdir))
        traces = list(logdir.glob("*.pt.trace.json"))
        assert len(traces) == 1, traces
        text = traces[0].read_text()
        k1_names = sorted(set(re.findall(r'"([^"]*sphere_sweep_kernel[^"]*)"',
                                         text)))
        assert k1_names, "the profile does not name K1's kernel"
        trace_mb = traces[0].stat().st_size / 1e6
    plain, with_ck = walls["plain"], walls["checkpoint"]
    return (f"CLI random 1280x720 100spp d10 --spp-chunk {OPS_CHUNK}: wall "
            f"without --checkpoint {plain[0]:.3f} / {plain[1]:.3f} s, with "
            f"{with_ck[0]:.3f} / {with_ck[1]:.3f} s (in turns; a snapshot "
            f"every {8 * OPS_CHUNK} spp and at the end; the same PNG), "
            f"launches {launched} | a child "
            f"killed after its first snapshot (rc {rc}) left samples_done "
            f"{done}; the resume ({resume_wall:.3f} s, K1 launches "
            f"{resume_launched}) is byte-equal to the uninterrupted PNG "
            f"(asserted) | --preview: {len(writes)} writes (>= 8 asserted), "
            f"wall {preview_wall:.3f} s | --watch: the default render, then "
            f"a re-render at 320x180x4 on the edit (asserted), wall "
            f"{watch_wall:.3f} s | --profile of 9 spp: wall "
            f"{profile_wall:.3f} s, trace {trace_mb:.1f} MB naming "
            f"{k1_names}")


# The four fits of examples/inverse_*.py on the port, at their defaults:
# (module, the sweep kernel its scene traces through).
FITS = (("inverse_geometry", "typed_sweep"), ("inverse_mirror", "typed_sweep"),
        ("inverse_glass", "sphere_sweep"),
        ("inverse_rendering", "sphere_sweep"))


# Where a JAX example script misses its own exit criterion at its
# defaults, what it ends with instead (python examples/inverse_<name>.py
# --cpu, as printed): examples/inverse_rendering.py recovers the color
# (0.002 of 0.800) but not the metal (1.221 of 1.100: the polished
# sphere's fuzz climbs to 1.13 and its albedo stays 0.09 off), so it
# exits 1, and the port's fit on the CPU ends at the same printed errors.
# Phase 23 holds such a fit to the reference's ending (within 0.01 of
# each printed error) and every other fit to its own criterion.
FIT_REFERENCE_MISSES = {"inverse_rendering": (0.002, 1.221)}


def fits_phase(reset_counts, counts):
    """Phase 23: each fit through its entry point at its own default size
    and steps: its exit criterion asserted (or, where the JAX script
    misses its own, the script's ending: ``FIT_REFERENCE_MISSES``);
    steps, wall, s/step, peak memory, the errors before and after, and
    the launches.  Returns the line."""
    import contextlib
    import importlib
    import io

    lines, missed = [], []
    with tempfile.TemporaryDirectory() as tmp:
        for name, sweep in FITS:
            fit = importlib.import_module(
                f"hyper_ray_tracer_tpu_torch.examples.{name}")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            printed = io.StringIO()
            t0 = time.monotonic()
            with contextlib.redirect_stdout(printed):
                r = fit.run(["--out", str(Path(tmp) / name)])
            wall = time.monotonic() - t0
            launched = counts()
            peak = torch.cuda.max_memory_allocated() / 1e9
            steps = len(r["losses"])
            assert launched[sweep] > 0, (name, launched)
            assert launched["segment_sum"] > 0, (name, launched)
            last = printed.getvalue().strip().splitlines()[-1]
            if name in FIT_REFERENCE_MISSES:
                final = r["errors"][len(r["errors"]) // 2:]
                ok = not r["passed"] and np.allclose(
                    final, FIT_REFERENCE_MISSES[name], rtol=0, atol=0.01)
            else:
                ok = r["passed"]
            if not ok:
                missed.append(name)
            lines.append(
                f"{name}: {steps} steps, wall {wall:.2f} s, "
                f"{r['seconds'] / steps:.4f} s/step, peak {peak:.2f} GB, "
                f"errors {', '.join(f'{e:.4g}' for e in r['errors'])}, "
                f"loss {r['losses'][0]:.4e} -> {r['losses'][-1]:.4e}, "
                f"launches {launched} ({last}; exit criterion "
                f"{'met' if r['passed'] else 'missed'})")
    assert not missed, f"{missed} did not end as asserted: " + \
        " | ".join(lines)
    return " | ".join(lines)


def deep_train_line(lanes, depth):
    """The train CLI (``python -m hyper_ray_tracer_tpu_torch.train``)
    on `random` at ``depth``, where it switches remat on; its JSON line
    and the peak device memory."""
    import contextlib
    import io

    from hyper_ray_tracer_tpu_torch.train import main as train_main

    W, H, spp = lanes
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train_main(["random", str(W), str(H), str(spp), str(depth),
                         "--steps", "1"])
    assert rc == 0, f"train CLI exit code {rc}"
    r = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert r["remat"] and np.isfinite(r["loss"]), r
    return (f"train CLI random {W}x{H}x{spp} d{depth} with remat: "
            f"{r['seconds_per_step']:.4f} s/step (one timed after one "
            f"warm-up), {r['value']:.4f} fwd+bwd camera Mrays/s, loss "
            f"{r['loss']:.6f}, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

# FP32 operations of K4's walk, counted from its contract (ops/bvh.py):
# a box's slab test (ops/intersect.py aabb_entry) 25: 6 sub and 6 mul,
# the min and max of each axis' pair (6), the reductions over the axes
# (4), the t_min and t_max clamps (2) and the compare (1); the NaN checks
# and the nearer child's compare are not counted.  Per ray once, 8: the
# three slab reciprocals and |d|^2 (5).  A leaf test costs its type's
# pair count (SWEEP_PAIR_OPS, +6 for a sphere that moves, +33 and the
# type's per-ray terms in a scene with ray transforms), the branch taken
# only on a hit left out as for the sweeps.  The tests are those these
# rays need: bvh_traverse_plain counts them (the root's box and two an
# inner step), and bvh_traverse_dfs_plain those of the first design's
# walk (one box a node).
BVH_BOX_OPS, BVH_RAY_OPS = 25, 8
# Bytes: a ray's o, d, time, active and bits read (37) and its t and
# index written (8); a node record (64; the first design's 32 a node); a
# primitive's tag and two records (36), and its transform (48) in a scene
# with ray transforms.
BVH_RAY_BYTES, BVH_PRIM_BYTES, BVH_XF_BYTES = 45, 36, 48
BVH_RECORD_BYTES, BVH_DFS_NODE_BYTES = 64, 32


def k4_bound(bvh, stats, kinds, n):
    """(bound, FP32 operations a ray) of the work that
    ``bvh_traverse_plain`` (or, by its ``node_tests``,
    ``bvh_traverse_dfs_plain``) counted in ``stats`` for n rays on a
    BVHScene ``bvh``; ``kinds`` maps each PT_* tag to "sphere", "rect" or
    "box"."""
    tests = stats["prim_tests"].cpu()
    tag = bvh.tag.cpu()
    slot = bvh.aux[:, 3].contiguous().view(torch.int32).cpu()
    dfs = "node_tests" in stats
    ops = (stats["node_tests"] if dfs else stats["box_tests"]) * BVH_BOX_OPS
    for ptype, kind in kinds.items():
        sel = tag == ptype
        k = int(tests[sel].sum())
        ops += k * SWEEP_PAIR_OPS[kind]
        if bvh.static.has_ray_xform:
            ops += k * (SWEEP_XFORM_OPS + SWEEP_RAY_OPS[kind])
        if kind == "sphere":
            ops += SWEEP_MOTION_OPS * int(tests[sel & (slot >= 0)].sum())
    ops += n * BVH_RAY_OPS
    tree_bytes = (bvh.tree.skip.shape[0] * BVH_DFS_NODE_BYTES if dfs
                  else bvh.nodes.shape[0] * BVH_RECORD_BYTES)
    n_bytes = (n * BVH_RAY_BYTES + tree_bytes + bvh.geo.shape[0]
               * (BVH_PRIM_BYTES + BVH_XF_BYTES * bvh.static.has_ray_xform))
    return bound(n_bytes, ops), ops / n


def flat_scene():
    """Zero-radius spheres on a grid in the plane y = 0 beside ordinary
    spheres centered in it (tests/test_torch_bvh.py flat_scene): every
    node over the zero-radius spheres alone is flat in y."""
    from hyper_ray_tracer_tpu_torch.models.scene import (
        CameraConfig,
        SceneBuilder,
    )

    b = SceneBuilder()
    mat = b.lambertian(b.solid((0.5, 0.5, 0.5)))
    for i in range(6):
        for j in range(6):
            b.sphere((2.0 * i, 0.0, 2.0 * j), 0.0, mat)
    for i in range(4):
        for j in range(2):
            b.sphere((30.0 + 2.0 * i, 0.0, 2.0 * j), 0.5, mat)
    return b.finalize(CameraConfig((0, 5, -20), (5, 0, 5), 40.0, 0.0),
                      (0, 0, 0), "flat")


def slab_nan_rays(scene, dev):
    """Rays in the plane y = 0 (d.y = +-0), each aimed exactly at a
    zero-radius sphere of ``flat_scene``: the sweep hits one, but every
    node over it meets the slab test as 0 * inf = NaN on both planes of
    y, and NaN-propagating min and max miss it
    (tests/test_torch_bvh.py slab_nan_rays)."""
    g = scene.arrays.geom
    pts = np.asarray(g.p0)[np.asarray(g.radius) == 0.0]
    dirs = np.float32([[1, 0, 1], [1, -0.0, 0.5], [-1, 0, 2],
                       [0.5, -0.0, -1], [2, 0, 1]])
    c = np.repeat(pts, len(dirs), 0)
    d = np.tile(dirs, (len(pts), 1))
    o = (c - 5.0 * d).astype(np.float32)
    rng = np.random.default_rng(len(o))
    time = rng.random(len(o)).astype(np.float32)
    bits = rng.integers(0, 2**32, len(o)).astype(np.int64)
    return tuple(torch.from_numpy(x).to(dev) for x in (o, d, time, bits))


# Phase 18's scenes and leaf sizes: every primitive type, media, motion
# and transforms, and the leaf sizes 1, 4 and 8 on `final`.
K4_CASES = (("random", 4), ("cornell", 4), ("cornell-smoke", 4),
            ("final", 1), ("final", 4), ("final", 8),
            ("sphereflake-small", 4), ("sphereflake", 4))
CASE_SHAPE = (320, 180)  # phase 18's correctness cases
K4_TIMED = ("random", "cornell", "cornell-smoke", "final",
            "sphereflake-small", "sphereflake")


def k4_phase(dev, kinds, W=1280, H=720):
    """K4 (``bvh_traverse``) against ``bvh_traverse_plain``, bit for bit:
    camera rays and bounces 1-2 of each of K4_CASES at 320x180, and the
    slab-NaN rays; then at the main path's shape (each K4_TIMED scene's
    camera rays at W x H, 1 spp) again bit for bit, with the node and leaf
    tests the rays need, K4's device time and bound, and K1's or K1b's
    device time on the same rays through the scene as built (the measured
    sweep-vs-BVH crossover).  Returns (case lines, {scene: measurements},
    the largest |t| gap on matched hits)."""
    from hyper_ray_tracer_tpu_torch import build_scene, prepare_scene
    from hyper_ray_tracer_tpu_torch.camera import make_basis
    from hyper_ray_tracer_tpu_torch.ops import rng as prng
    from hyper_ray_tracer_tpu_torch.ops.bvh import (
        bvh_traverse,
        bvh_traverse_dfs_plain,
        bvh_traverse_plain,
    )
    from hyper_ray_tracer_tpu_torch.ops.sphere_sweep import sphere_sweep
    from hyper_ray_tracer_tpu_torch.ops.typed_sweep import typed_sweep
    from hyper_ray_tracer_tpu_torch.render import bounce_step, init_state
    from hyper_ray_tracer_tpu_torch.scene_tensors import to_device

    def bvh_tensors(scene, leaf):
        arrays, tree, _ = prepare_scene(scene, "bvh", leaf)
        return to_device(arrays, scene.static, dev, tree)

    def camera(scene, w, h):
        pix = torch.arange(w * h, dtype=torch.int64, device=dev)
        return init_state(make_basis(scene.camera, w, h), w, h, pix,
                          torch.zeros_like(pix), 0)

    def plain(st, *args, stats=None):
        return bvh_traverse_plain(st.bvh.tree, st.bvh.prims, *args, T_MIN,
                                  st.bvh.static, stats=stats)

    def check(label, st, o, d, tm, active, bits, stats=None):
        args = tuple(x.contiguous() for x in (o, d, tm, active, bits))
        t_k, b_k = bvh_traverse(st.bvh, *args, T_MIN)
        torch.cuda.synchronize()
        t_p, b_p = plain(st, *args, stats=stats)
        errs.append(sweep_rules(f"K4 {label}", t_k, b_k, t_p, b_p,
                                args[3])[2])
        return args, t_k, b_k

    lines, hits, errs = [], {}, []
    for name, leaf in K4_CASES:
        scene = build_scene(name)
        st = bvh_tensors(scene, leaf)
        s = camera(scene, *CASE_SHAPE)
        share = []
        for b in range(3):
            _, _, b_k = check(f"{name} leaf {leaf} bounce {b}", st, s.o,
                              s.d, s.time, s.alive,
                              prng.bounce_base(s.base, b))
            share.append(f"{(b_k >= 0).float().mean().item():.3f}")
            s = bounce_step(st, scene.background, s, b)
        lines.append(f"{name} leaf {leaf} (hit share by bounce "
                     f"{'/'.join(share)})")
    flat = flat_scene()
    for leaf in (1, 4, 8):
        st = bvh_tensors(flat, leaf)
        o, d, tm, bits = slab_nan_rays(flat, dev)
        active = torch.ones(o.shape[0], dtype=torch.bool, device=dev)
        _, _, b_k = check(f"slab-NaN rays leaf {leaf}", st, o, d, tm,
                          active, bits)
        hits[leaf] = (b_k >= 0).float().mean().item()
    lines.append(f"{o.shape[0]} slab-NaN rays, leaf 1/4/8 (hit share "
                 + "/".join(f"{v:.3f}" for v in hits.values())
                 + "; the sweep hits every one)")

    timed = {}
    for name in K4_TIMED:
        scene = build_scene(name)
        st = bvh_tensors(scene, 4)
        cam = camera(scene, W, H)
        stats = {}
        args, t_k, b_k = check(f"{name} camera {W}x{H}", st, cam.o, cam.d,
                               cam.time, cam.alive,
                               prng.bounce_base(cam.base, 0), stats)
        k4_args = (st.bvh, *args, T_MIN)
        n = cam.o.shape[0]
        sweep_t = to_device(scene.arrays, scene.static, dev)
        if sweep_t.sphere_only:
            sweep, sweep_name = sphere_sweep, "K1"
            sweep_args = (*sweep_t.spheres, *args[:4], T_MIN)
        else:
            sweep, sweep_name = typed_sweep, "K1b"
            sweep_args = (sweep_t.sweep, *args, T_MIN)
        t_s, b_s = sweep(*sweep_args)
        # The walk's winners in the scene's own order: the reordered
        # geometry's stable_id is the canonical index.
        canon = torch.where(b_k >= 0, st.arrays.geom.stable_id[
            b_k.clamp(min=0).long()].to(torch.int32), -1)
        same = (canon == b_s) & (t_k == t_s)
        ties = int((~same & (t_k == t_s)).sum())
        dfs = {}
        t_d, b_d = bvh_traverse_dfs_plain(st.bvh.tree, st.bvh.prims, *args,
                                          T_MIN, st.bvh.static, stats=dfs)
        k4b, ops = k4_bound(st.bvh, stats, kinds, n)
        row = dict(
            n=n, nodes=st.bvh.tree.skip.shape[0], prims=scene.static.n_prims,
            box_tests=stats["box_tests"] / n,
            steps=stats["inner_steps"] / n, stack=stats["max_stack"],
            leaf_tests=int(stats["prim_tests"].sum()) / n,
            dfs_tests=dfs["node_tests"] / n,
            dfs_leaf_tests=int(dfs["prim_tests"].sum()) / n,
            bound=k4b, ops=ops, dfs_bound=k4_bound(st.bvh, dfs, kinds, n)[0],
            dfs_differ=int(((t_d != t_k) | (b_d != b_k)).sum()),
            ms=device_ms(bvh_traverse, k4_args, 10),
            sweep=sweep_name,
            sweep_ms=device_ms(sweep, sweep_args,
                               2 if name == "sphereflake" else 10),
            differ=int((~same).sum()), ties=ties)
        if name == "sphereflake":
            row["call_ms"], row["plain_ms"] = in_turns(
                lambda *a: plain(st, *a[1:-1]), bvh_traverse, k4_args, 1,
                10)
        timed[name] = row
    return lines, timed, max(errs)


def k4_chunk(dev, kinds, W=1280, H=720):
    """K4 at the main path's real shape: the first chunk of `sphereflake`'s
    CLI default (1280x720, render.spp_per_chunk's 9 spp: 8,294,400 lanes),
    bounces 0-2, each bounce's lanes those the compaction kept, as
    render.trace_paths runs them.  Per bounce: the lanes, K4's device time,
    the tests the rays need and K4's bound, and K4 against the plain
    version on those lanes, bit for bit."""
    from hyper_ray_tracer_tpu_torch import RenderSettings, build_scene
    from hyper_ray_tracer_tpu_torch import prepare_scene
    from hyper_ray_tracer_tpu_torch.camera import make_basis
    from hyper_ray_tracer_tpu_torch.ops import rng as prng
    from hyper_ray_tracer_tpu_torch.ops.bvh import (
        bvh_traverse,
        bvh_traverse_plain,
    )
    from hyper_ray_tracer_tpu_torch.render import (
        WavefrontState,
        bounce_step,
        init_state,
        spp_per_chunk,
    )
    from hyper_ray_tracer_tpu_torch.scene_tensors import to_device

    spp = spp_per_chunk(RenderSettings(W, H, 100, 10))
    scene = build_scene("sphereflake")
    arrays, tree, _ = prepare_scene(scene, "bvh", 4)
    st = to_device(arrays, scene.static, dev, tree)
    pix = torch.arange(W * H, dtype=torch.int64, device=dev)
    s = init_state(make_basis(scene.camera, W, H), W, H, pix.repeat(spp),
                   torch.arange(spp, dtype=torch.int64,
                                device=dev).repeat_interleave(W * H), 0)
    rows, errs = [], []
    for b in range(3):
        args = tuple(x.contiguous() for x in (
            s.o, s.d, s.time, s.alive, prng.bounce_base(s.base, b)))
        n = args[0].shape[0]
        t_k, b_k = bvh_traverse(st.bvh, *args, T_MIN)
        torch.cuda.synchronize()
        stats = {}
        t_p, b_p = bvh_traverse_plain(st.bvh.tree, st.bvh.prims, *args,
                                      T_MIN, st.bvh.static, stats=stats)
        errs.append(sweep_rules(f"K4 sphereflake chunk bounce {b}", t_k,
                                b_k, t_p, b_p, args[3])[2])
        rows.append(dict(
            bounce=b, lanes=n, hits=int((b_k >= 0).sum()),
            ms=device_ms(bvh_traverse, (st.bvh, *args, T_MIN), 5),
            box_tests=stats["box_tests"] / n,
            steps=stats["inner_steps"] / n, stack=stats["max_stack"],
            leaf_tests=int(stats["prim_tests"].sum()) / n,
            bound=k4_bound(st.bvh, stats, kinds, n)[0]))
        if b < 2:
            s = bounce_step(st, scene.background, s, b)
            keep = s.alive.nonzero().squeeze(1)
            s = WavefrontState(*(x.index_select(0, keep) for x in s))
    return rows, spp, max(errs)


def k4_chunk_line(rows, spp):
    return (f"K4 at the main path's shape, sphereflake's first CLI chunk "
            f"(1280x720x{spp}, leaf 4), bit-equal to the plain version on "
            "every bounce (asserted): " + "; ".join(
                f"bounce {r['bounce']}: {r['lanes']} lanes ({r['hits']} "
                f"hit), K4 {r['ms']:.4f} ms on the device, "
                f"{r['box_tests']:.2f} box tests ({r['steps']:.2f} inner "
                f"steps, stack up to {r['stack']}) and {r['leaf_tests']:.2f}"
                f" leaf tests a ray, bound {r['bound'][0]:.6f} ms "
                f"({r['bound'][1]}), {r['bound'][0] / r['ms']:.3f} of it"
                for r in rows))


def k4_line(lines, timed, ptxas_note):
    flake = timed["sphereflake"]
    return (
        "bvh_traverse (K4) vs bvh_traverse_plain, bit-equal on every case "
        "and inactive rays at (BIG, -1) (asserted): camera rays and bounces"
        " 1-2 at 320x180 of " + "; ".join(lines)
        + " | at the main path's shape (camera rays, 1280x720, leaf 4, "
        "bit-equal again): " + "; ".join(
            f"{name} ({v['prims']} primitives, {v['nodes']} nodes): "
            f"{v['box_tests']:.2f} box tests ({v['steps']:.2f} inner steps,"
            f" stack up to {v['stack']}) and {v['leaf_tests']:.2f} leaf "
            f"tests a ray (the JAX-order walk {v['dfs_tests']:.2f} and "
            f"{v['dfs_leaf_tests']:.2f}, parting from it on "
            f"{v['dfs_differ']} rays), K4 {v['ms']:.4f} ms on the device, "
            f"bound {v['bound'][0]:.6f} ms ({v['bound'][1]}, "
            f"{v['ops']:.1f} FP32 operations a ray), "
            f"{v['bound'][0] / v['ms']:.3f} of it (the first design's "
            f"bound {v['dfs_bound'][0]:.6f} ms, {v['dfs_bound'][1]}); "
            f"{v['sweep']} {v['sweep_ms']:.4f} ms on the same rays "
            f"({v['sweep_ms'] / v['ms']:.2f}x K4's), winner or t other than "
            f"the walk's on {v['differ']} rays ({v['ties']} of them ties "
            "at one t)"
            for name, v in timed.items())
        + f" | sphereflake: K4 {flake['call_ms']:.4f} ms a call back to "
        f"back, plain {flake['plain_ms']:.4f} ms; ptxas: {ptxas_note}")


# K5's work, counted from its contract (ops/cluster_sweep.py) as K4's: a
# box test BVH_BOX_OPS (its slab distances and the compare against the
# running best), per ray BVH_RAY_OPS, a slot test its type's pair count
# (+6 for a sphere that moves, +33 and the type's per-ray terms in a
# transformed group); a pad's test is a tag load and no operation.
# Bytes: a ray's BVH_RAY_BYTES, a cluster's box (32), a slot's tag and
# two records (BVH_PRIM_BYTES), and its transform (BVH_XF_BYTES) in a
# transformed group.
CLUSTER_BOX_BYTES = 32


def k5_bound(cs, stats, kinds, n):
    """(bound, FP32 operations a ray) of the tests that
    ``cluster_sweep_plain`` counted in ``stats`` for n rays on a
    ClusterScene ``cs``."""
    tests = stats["prim_tests"].cpu()
    tag = cs.tag.cpu()
    slot = cs.aux[:, 3].contiguous().view(torch.int32).cpu()
    xf = torch.zeros_like(tag, dtype=torch.bool)
    for g in cs.tail:
        xf[g.start:g.start + g.width] = g.xform
    for g, r in zip(cs.runs, cs.layout.runs):
        xf[r.base:r.base + r.n_clusters * r.width] = g.xform
    ops = stats["box_tests"] * BVH_BOX_OPS + n * BVH_RAY_OPS
    for ptype, kind in kinds.items():
        sel = tag == ptype
        ops += int(tests[sel].sum()) * SWEEP_PAIR_OPS[kind]
        ops += int(tests[sel & xf].sum()) * (SWEEP_XFORM_OPS
                                             + SWEEP_RAY_OPS[kind])
        if kind == "sphere":
            ops += SWEEP_MOTION_OPS * int(tests[sel & (slot >= 0)].sum())
    n_bytes = (n * BVH_RAY_BYTES + cs.boxes.shape[0] * CLUSTER_BOX_BYTES
               + tag.shape[0] * BVH_PRIM_BYTES
               + int(xf.sum()) * BVH_XF_BYTES)
    return bound(n_bytes, ops), ops / n


def k5_cases(dev, kinds):
    """K5 (``cluster_sweep``) against ``cluster_sweep_plain``, bit for bit,
    t and slot: bounces 0-2 of `final` at the bench workload's 400x225x16,
    of `random` at 1280x720 and of sphereflake(3) at 320x180; a run of
    4,096 clusters (`sphereflake` at 16 primitives a cluster, camera rays
    and bounce 1 at 320x180) and its first 1,000 clusters (a ragged last
    window); `sphereflake`'s camera rays at 1280x720, timed in raster and
    in block order beside K4 and K1 on the same rays, with the tests the
    rays need and K5's bound; bounces 0-2 of one full chunk of its CLI
    default, timed in launch order and in the render's order (camera
    lanes in block order, survivors sorted by the coherence key), where
    K5 must give every ray what it gave it in launch order.  Returns
    (case lines, the camera rays' row, the chunk's rows, the largest |t|
    gap)."""
    from hyper_ray_tracer_tpu_torch import (
        RenderSettings,
        build_scene,
        prepare_scene,
    )
    from hyper_ray_tracer_tpu_torch.camera import make_basis
    from hyper_ray_tracer_tpu_torch.models import clusters as C
    from hyper_ray_tracer_tpu_torch.models.builders import sphereflake
    from hyper_ray_tracer_tpu_torch.ops import rng as prng
    from hyper_ray_tracer_tpu_torch.ops.bvh import bvh_traverse
    from hyper_ray_tracer_tpu_torch.ops.cluster_sweep import (
        cluster_sweep,
        cluster_sweep_plain,
        cut_run,
    )
    from hyper_ray_tracer_tpu_torch.ops.sphere_sweep import sphere_sweep
    from hyper_ray_tracer_tpu_torch.render import (
        WavefrontState,
        block_order,
        bounce_step,
        init_state,
        spp_per_chunk,
    )
    from hyper_ray_tracer_tpu_torch.scene_tensors import to_device

    errs = []

    def upload(scene, mode):
        arrays, structure, _ = prepare_scene(scene, mode)
        return to_device(arrays, scene.static, dev, structure)

    def camera(scene, w, h, spp=1):
        pix = torch.arange(w * h, dtype=torch.int64, device=dev)
        return init_state(make_basis(scene.camera, w, h), w, h,
                          pix.repeat(spp), torch.arange(
                              spp, dtype=torch.int64,
                              device=dev).repeat_interleave(w * h), 0)

    def check(label, cs, s, b, stats=None):
        args = tuple(x.contiguous() for x in (
            s.o, s.d, s.time, s.alive, prng.bounce_base(s.base, b)))
        t_k, b_k = cluster_sweep(cs, *args, T_MIN)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        t_p, b_p = cluster_sweep_plain(cs, *args, T_MIN, stats=stats)
        torch.cuda.synchronize()
        plain_s = time.monotonic() - t0
        errs.append(sweep_rules(f"K5 {label}", t_k, b_k, t_p, b_p,
                                args[3])[2])
        return args, t_k, b_k, plain_s

    def step(scene, st, s, b):
        s = bounce_step(st, scene.background, s, b)
        keep = s.alive.nonzero().squeeze(1)
        return WavefrontState(*(x.index_select(0, keep) for x in s)), keep

    def waves(label, scene, st, s, bounces=3):
        share = []
        for b in range(bounces):
            _, _, b_k, _ = check(f"{label} bounce {b}", st.cluster, s, b)
            share.append(f"{(b_k >= 0).float().mean().item():.3f}")
            if b < bounces - 1:
                s = step(scene, st, s, b)[0]
        return f"{label} (hit share by bounce {'/'.join(share)})"

    lines = []
    final = build_scene("final")
    lines.append(waves("final 400x225x16", final, upload(final, "cluster"),
                       camera(final, 400, 225, 16)))
    rnd = build_scene("random")
    lines.append(waves("random 1280x720", rnd, upload(rnd, "cluster"),
                       camera(rnd, 1280, 720)))
    sf3 = sphereflake(3, "sphereflake-3")
    lines.append(waves("sphereflake(3) 320x180", sf3, upload(sf3, "cluster"),
                       camera(sf3, 320, 180)))

    flake = build_scene("sphereflake")
    # A run of 4,096 clusters (MAX_CLUSTERS_PER_RUN), 16 windows, and
    # its first 1,000 (a last window of 232).
    target = C.CLUSTER_TARGET_PRIMS
    C.CLUSTER_TARGET_PRIMS = 16
    try:
        st16 = upload(flake, "cluster")
    finally:
        C.CLUSTER_TARGET_PRIMS = target
    run16 = st16.cluster.layout.runs[0]
    assert run16.n_clusters == 4096, run16.n_clusters
    lines.append(waves(f"sphereflake {run16.n_clusters} x {run16.width} "
                       "320x180", flake, st16, camera(flake, 320, 180), 2))
    cut = cut_run(st16.cluster, 1000)
    lines.append(waves("sphereflake's first 1000 of those clusters 320x180",
                       flake, st16._replace(cluster=cut),
                       camera(flake, 320, 180), 2))
    del st16, cut

    # sphereflake's camera rays: K5 timed beside K4 and K1, in raster and
    # in block order (the render's launch order).
    st = upload(flake, "cluster")
    cam = camera(flake, 1280, 720)
    stats = {}
    args, _, b_k, _ = check("sphereflake camera 1280x720", st.cluster, cam,
                            0, stats)
    n = args[0].shape[0]
    k5_args = (st.cluster, *args, T_MIN)
    perm = torch.from_numpy(block_order(1280, 720).astype(np.int64)).to(dev)
    blocked = (st.cluster, *(x[perm].contiguous() for x in args), T_MIN)
    bvh_t = upload(flake, "bvh")
    sweep_t = to_device(flake.arrays, flake.static, dev)
    k5b, ops = k5_bound(st.cluster, stats, kinds, n)
    cam_row = dict(
        n=n, hits=int((b_k >= 0).sum()), box_tests=stats["box_tests"] / n,
        visits=stats["cluster_visits"] / n,
        slot_tests=int(stats["prim_tests"].sum()) / n, bound=k5b, ops=ops,
        ms=device_ms(cluster_sweep, k5_args, 10),
        block_ms=device_ms(cluster_sweep, blocked, 10),
        k4_ms=device_ms(bvh_traverse, (bvh_t.bvh, *args, T_MIN), 10),
        k1_ms=device_ms(sphere_sweep, (*sweep_t.spheres, *args[:4], T_MIN),
                        2))
    cam_row["call_ms"], cam_row["plain_ms"] = in_turns(
        lambda *a: cluster_sweep_plain(*a), cluster_sweep, k5_args, 1, 10)
    del bvh_t, sweep_t

    # One full chunk of the CLI default, bounces 0-2: in launch order (the
    # twin's check), and in the render's order (render.trace_paths:
    # camera lanes in block order, each compaction's survivors stably
    # sorted by the coherence key), a permutation of the same rays.
    spp = spp_per_chunk(RenderSettings(1280, 720, 100, 10))
    s = camera(flake, 1280, 720, spp)
    n0 = s.o.shape[0]
    ids = torch.arange(n0, device=dev)  # launch lane of each row of s
    order = (perm + torch.arange(spp, device=dev)[:, None]
             * (1280 * 720)).reshape(-1)  # the render's lanes, by id
    chunk = []
    for b in range(3):
        stats = {}
        args, t_k, b_k, plain_s = check(f"sphereflake chunk bounce {b}",
                                        st.cluster, s, b, stats)
        pos = torch.full((n0,), -1, dtype=torch.int64, device=dev)
        pos[ids] = torch.arange(ids.numel(), device=dev)
        rows = pos[order]
        if b > 0:  # the render's survivors, sorted by the coherence key
            order, rows = order[rows >= 0], rows[rows >= 0]
            key = st.cluster.key(s.o[rows], s.d[rows])
            srt = torch.sort(key, stable=True).indices
            order, rows = order[srt], rows[srt]
        r_args = (st.cluster, *(x[rows].contiguous() for x in args), T_MIN)
        t_r, b_r = cluster_sweep(*r_args)
        assert torch.equal(t_r, t_k[rows]) and torch.equal(b_r, b_k[rows]), \
            f"K5 chunk bounce {b}: the render's order changed a ray's hit"
        n_b = args[0].shape[0]
        chunk.append(dict(
            bounce=b, lanes=n_b, hits=int((b_k >= 0).sum()),
            ms=device_ms(cluster_sweep, (st.cluster, *args, T_MIN), 3),
            render_ms=device_ms(cluster_sweep, r_args, 3),
            visits=stats["cluster_visits"] / n_b,
            slot_tests=int(stats["prim_tests"].sum()) / n_b,
            bound=k5_bound(st.cluster, stats, kinds, n_b)[0],
            plain_s=plain_s))
        if b < 2:
            s, keep = step(flake, st, s, b)
            ids = ids[keep]
    return lines, cam_row, chunk, spp, max(errs)


def cluster_phase(dev, kinds, reset_counts, counts, flake_bvh_png,
                  final_sweep_png, ptxas_note):
    """Phase 24: cluster mode (K5) end to end.  K5 against its plain
    version (``k5_cases``); `sphereflake` through the CLI at its defaults
    with ``--intersector cluster`` (the host builds timed: the native BVH
    build against NumPy's, ``build_clusters``), its PNG against BVH
    mode's, and its render profiled by layer (K5 by bounce); two goldens
    in cluster mode; the bench workload on `final` in cluster mode, its
    PNG against sweep mode's; a cluster-mode train step on `final` at
    bench_grad.py's shape, two steps from one state bit-equal, card
    against CPU gradients with the pads excluded.  Returns (the phase's
    line, K5's record)."""
    from hyper_ray_tracer_tpu_torch import (
        RenderSettings,
        build_scene,
        render_image,
    )
    from hyper_ray_tracer_tpu_torch.__main__ import main as cli_main
    from hyper_ray_tracer_tpu_torch.models.bvh_build import build_bvh
    from hyper_ray_tracer_tpu_torch.models.clusters import build_clusters
    from hyper_ray_tracer_tpu_torch.scene_tensors import to_device
    from hyper_ray_tracer_tpu_torch.utils.image import read_png

    t_phase = time.monotonic()
    lines, cam, chunk, spp, err = k5_cases(dev, kinds)
    cases_s = time.monotonic() - t_phase

    # The host builds of `sphereflake` (each once, after phase 19's).
    flake = build_scene("sphereflake")
    n = flake.static.n_prims
    builds = {}
    for label, fn in (
            ("native BVH", lambda: build_bvh(flake.arrays.geom, 4)),
            ("NumPy BVH", lambda: build_bvh(flake.arrays.geom, 4,
                                            use_native=False)),
            ("build_clusters", lambda: build_clusters(flake.arrays.geom,
                                                      n))):
        t0 = time.monotonic()
        out = fn()
        builds[label] = time.monotonic() - t0
    padded, layout = out
    t0 = time.monotonic()
    to_device(flake.arrays._replace(geom=padded), flake.static, dev, layout)
    torch.cuda.synchronize()
    upload_s = time.monotonic() - t0

    # The CLI default on sphereflake in cluster mode.
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "sphereflake.png"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.monotonic()
        rc = cli_main(["--scene", "sphereflake", "--intersector", "cluster",
                       "--output", str(out)])
        wall = time.monotonic() - t0
        launched = counts()
        assert rc == 0, f"CLI exit code {rc}"
        assert launched["cluster_sweep"] > 0, \
            "the cluster path never launched cluster_sweep"
        assert launched["bvh_traverse"] == 0 and \
            launched["sphere_sweep"] == 0, launched
        png = read_png(out)
    peak = torch.cuda.max_memory_allocated() / 1e9
    assert png.shape == (720, 1280, 3), png.shape
    rays = 1280 * 720 * 100
    by_layer = render_profile(dev, "sphereflake", RenderSettings(
        1280, 720, 100, 10, intersector="cluster"))
    parts = (png != flake_bvh_png).any(-1)
    flake_err = golden_errors(png.astype(np.float64) / 255.0,
                              flake_bvh_png.astype(np.float64) / 255.0)
    assert parts.mean() <= 1e-3, int(parts.sum())

    # Two goldens rendered in cluster mode.
    goldens = []
    for name, shape in (("random", (160, 90, 2, 8)),
                        ("final", (160, 90, 1, 5))):
        golden = np.load(ROOT / "tests" / "golden" /
                         f"{name}_{shape[0]}x{shape[1]}_{shape[2]}spp_"
                         f"d{shape[3]}.npy")
        reset_counts()
        img = render_image(build_scene(name), RenderSettings(
            *shape, intersector="cluster"), dev)
        assert counts()["cluster_sweep"] > 0, f"{name}: golden missed K5"
        med, mean, outl = golden_errors(img, golden)
        goldens.append(f"{name} median {med:.3e} mean {mean:.3e} outliers "
                       f"{outl:.4f}")

    # The bench workload on final in cluster mode, through the CLI.
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "final.png"
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.monotonic()
        rc = cli_main(["--scene", "final", "--intersector", "cluster",
                       "--width", "400", "--height", "225", "--samples",
                       "16", "--depth", "10", "--output", str(out)])
        bench_wall = time.monotonic() - t0
        bench_launched = counts()
        assert rc == 0, f"CLI exit code {rc}"
        assert bench_launched["cluster_sweep"] > 0 and \
            bench_launched["shade"] > 0, bench_launched
        assert bench_launched["typed_sweep"] == 0, bench_launched
        bench_png = read_png(out)
    bench_parts = (bench_png != final_sweep_png).any(-1)
    bench_err = golden_errors(bench_png.astype(np.float64) / 255.0,
                              final_sweep_png.astype(np.float64) / 255.0)

    # A cluster-mode train step on final.
    final = build_scene("final")
    train = train_run(final, dev, TRAIN_SHAPE, 3, reset_counts, counts,
                      intersector="cluster")
    assert train["launched"]["cluster_sweep"] > 0, train["launched"]
    assert train["launched"]["typed_sweep"] == 0, train["launched"]
    repeat = determinism_line(final, dev, TRAIN_SHAPE, "cluster")
    _, lay = build_clusters(final.arrays.geom, final.static.n_prims)
    pads = torch.from_numpy(lay.src < 0)
    shape = (64, 36, 2, 4)
    loss_c, g_c = loss_and_grads(final, "cpu", *shape, "cluster")
    loss_g, g_g = loss_and_grads(final, dev, *shape, "cluster")
    share = CARD_GRAD_SHARE["final"]
    for g in (g_c, g_g):
        for k in ("geom.p0", "geom.p1", "geom.radius"):
            assert not g[k][pads].any(), k  # a pad never takes a gradient
            g[k] = g[k][~pads]
    gaps = grad_gaps("final cluster", g_c, g_g, share)
    assert abs(loss_g - loss_c) <= share * abs(loss_c), (loss_g, loss_c)

    total_s = time.monotonic() - t_phase
    line = (
        "cluster_sweep (K5) vs cluster_sweep_plain, bit-equal t and slot on "
        "every case and inactive rays at (BIG, -1) (asserted): "
        + "; ".join(lines)
        + f" | sphereflake's {cam['n']} camera rays (1280x720, bit-equal): "
        f"{cam['hits']} hit, {cam['box_tests']:.1f} box tests, "
        f"{cam['visits']:.3f} cluster visits and {cam['slot_tests']:.1f} "
        f"slot tests a ray, K5 {cam['ms']:.4f} ms on the device in raster "
        f"order, {cam['block_ms']:.4f} in block order (a call back to back "
        f"{cam['call_ms']:.4f}, plain {cam['plain_ms']:.4f}), bound "
        f"{cam['bound'][0]:.6f} ms ({cam['bound'][1]}, {cam['ops']:.1f} "
        f"FP32 operations a ray), {cam['bound'][0] / cam['ms']:.3f} of it; "
        f"K4 {cam['k4_ms']:.4f} ms and K1 {cam['k1_ms']:.4f} ms on the same "
        f"rays (K5 {cam['ms'] / cam['k4_ms']:.2f}x K4's) | its first CLI "
        f"chunk (1280x720x{spp}), every lane bit-equal in launch order, "
        "every ray's hit the same in the render's order (block order, then "
        "the coherence key): " + "; ".join(
            f"bounce {r['bounce']}: {r['lanes']} lanes ({r['hits']} hit), "
            f"K5 {r['ms']:.4f} ms in launch order "
            f"({r['ms'] * 1e6 / r['lanes']:.2f} ns a lane, "
            f"{r['ms'] * cam['n'] / r['lanes'] / cam['ms']:.2f}x a camera "
            f"lane's), {r['render_ms']:.4f} ms in the render's order "
            f"({r['render_ms'] * 1e6 / r['lanes']:.2f} ns a lane), "
            f"{r['visits']:.3f} cluster visits and {r['slot_tests']:.1f} "
            f"slot tests a ray, bound {r['bound'][0]:.6f} ms "
            f"({r['bound'][1]}), plain {r['plain_s']:.2f} s" for r in chunk)
        + f" | CLI sphereflake --intersector cluster 1280x720 100spp d10 "
        f"({rays} camera rays): wall {wall:.3f} s, "
        f"{rays / wall / 1e6:.3f} camera Mrays/s, launches {launched}, "
        f"peak device memory {peak:.2f} GB; its PNG against BVH mode's "
        f"(phase 19): {int(parts.sum())} pixels differ ({parts.mean():.2e}"
        f", bound 1e-3, asserted), median / mean err / outliers "
        f"{flake_err[0]:.3e} / {flake_err[1]:.3e} / {flake_err[2]:.4f} "
        f"(golden bounds, asserted) | by layer: {by_layer} | host builds "
        "of sphereflake: "
        + ", ".join(f"{k} {v:.4f} s" for k, v in builds.items())
        + f", the cluster-mode upload (to_device) {upload_s:.3f} s | "
        "goldens in cluster mode (asserted): " + "; ".join(goldens)
        + f" | CLI final --intersector cluster 400x225 16spp d10: wall "
        f"{bench_wall:.3f} s, launches {bench_launched}, PNG against "
        f"phase 9's sweep-mode PNG: {int(bench_parts.sum())} pixels differ,"
        f" median / mean err / outliers {bench_err[0]:.3e} / "
        f"{bench_err[1]:.3e} / {bench_err[2]:.4f} (asserted) | train step "
        + train_line("final (cluster)", TRAIN_SHAPE, train)
        + f" | two steps from one state: {repeat} | card vs CPU gradients "
        f"at {shape[0]}x{shape[1]}x{shape[2]} d{shape[3]}, pads excluded "
        f"(each 0 on both, asserted): loss card {loss_g:.6f} cpu "
        f"{loss_c:.6f}; |card - cpu| / |cpu| by key {gaps} (bound {share})"
        f" | ptxas: {ptxas_note} | phase {total_s:.1f} s (its K5 cases "
        f"{cases_s:.1f} s)")
    record = {"name": "cluster_sweep", "route": "cuda",
              "source": "hyper_ray_tracer_tpu_torch/csrc/cluster_sweep.cu",
              "replaces": "hyper_ray_tracer_tpu/ops/cluster_sweep.py:245",
              "launches": launched["cluster_sweep"], "max_abs_err": err,
              "ms": cam["ms"], "plain_ms": cam["plain_ms"],
              "bound_ms": cam["bound"][0], "bound_by": cam["bound"][1],
              "library_ms": None}
    return line, record


# Phase 25's shapes: `final`'s bench chunk (bounces 0-2 of K1b),
# `sphereflake`'s camera rays in sweep mode (K1) and its sweep-mode render.
PART_FINAL_SHAPE = (400, 225, 16)
PART_FLAKE_RAYS = (1280, 720)
PART_FLAKE_RENDER = (640, 360, 4)
PART_RANDOM_ARGV = ()  # the CLI default


def masked_fp_ops(sw, kinds, n, lanes):
    """FP32 operations of a sweep over the plan of ``sw`` (a SweepScene) on
    ``n`` active lanes of which ``lanes[i]`` fold group i's tiles: what the
    partitioned twin folds, by the SWEEP_* counts (``sweep_fp_ops``'s, a
    tile's pairs weighted by the lanes that fold it; a type's per-ray terms
    and a shutter slot's factor once for every lane that folds some tile
    needing them).  With every lane in every group it is n times
    ``sweep_fp_ops``.  Returns (operations, ray-primitive pairs)."""
    slot = sw.aux[:, 3].contiguous().view(torch.int32).cpu()
    ops = pairs = 0
    per_ray, slots = {}, {}
    for tile in sw.plan:
        m = n if tile.group < 0 else lanes[tile.group]
        kind = kinds[tile.ptype]
        pairs += m * tile.width
        ops += m * tile.width * SWEEP_PAIR_OPS[kind]
        if tile.xform:
            ops += m * tile.width * (SWEEP_XFORM_OPS + SWEEP_RAY_OPS[kind])
        else:
            per_ray[kind] = max(per_ray.get(kind, 0),
                                m * SWEEP_RAY_OPS[kind])
        if tile.motion:
            s = slot[tile.start:tile.start + tile.width]
            ops += m * SWEEP_MOTION_OPS * int((s >= 0).sum())
            for v in set(s[s >= 0].tolist()):
                slots[v] = max(slots.get(v, 0), m)
    return (ops + sum(per_ray.values())
            + SWEEP_SHUTTER_OPS * sum(slots.values())), pairs


def partitioned_sweep_case(label, kernel, plain, st, s, bits, kinds,
                           groups_kw, reps):
    """The partitioned form of one sweep (K1 when ``bits`` is None, else
    K1b) on the wavefront ``s``: the lanes' group masks by the box test,
    the kernel masked in launch order and in category order (the stable
    sort of the render's compaction), held bit for bit to the masked twin
    and to the unmasked kernel, and timed on the device all three ways;
    the pairs each form folds (the twin's count) and its bound.  A lane's
    fold is its own, so the twin in category order is the launch-order
    twin permuted."""
    from hyper_ray_tracer_tpu_torch.ops import partition

    G = len(st.groups)
    mask = partition.group_mask(st.groups, s.o, s.d, st.group_aabbs)
    idx = torch.sort((1 << G) - 1 - mask.int(), stable=True).indices

    def args_of(order):
        fields = [s.o, s.d, s.time, s.alive] + ([] if bits is None
                                                else [bits])
        if order is not None:
            fields = [x[order] for x in fields]
        fields = [x.contiguous() for x in fields]
        head = (st.sweep,) if bits is not None else tuple(st.spheres)
        return (*head, *fields, T_MIN)

    args, args_c, mask_c = args_of(None), args_of(idx), mask[idx].contiguous()

    def masked(*a):
        return kernel(*a[:-1], mask=a[-1], **groups_kw)

    t_u, b_u = kernel(*args)
    t_m, b_m = masked(*args, mask)
    t_c, b_c = masked(*args_c, mask_c)
    torch.cuda.synchronize()
    t_p, b_p = plain(*args, mask=mask, **groups_kw)
    for what, t, b, t_r, b_r in (
            ("launch order vs twin", t_m, b_m, t_p, b_p),
            ("category order vs twin", t_c, b_c, t_p[idx], b_p[idx]),
            ("launch order vs unmasked", t_m, b_m, t_u, b_u)):
        assert torch.equal(t, t_r) and torch.equal(b, b_r), (label, what)
    n = int(s.alive.sum())
    lanes = [int(((mask & partition.group_bit(G, i)) != 0)[s.alive].sum())
             for i in range(G)]
    sw = st.sweep
    ops_u, pairs_u = masked_fp_ops(sw, kinds, n, [n] * G)
    ops_m, pairs_m = masked_fp_ops(sw, kinds, n, lanes)
    n_all = s.o.shape[0]
    lane_bytes = 45 if bits is not None else 37
    return dict(
        label=label, n=n_all, lanes=lanes, pairs_u=pairs_u, pairs_m=pairs_m,
        ms_u=device_ms(kernel, args, reps),
        ms_m=device_ms(masked, (*args, mask), reps),
        ms_c=device_ms(masked, (*args_c, mask_c), reps),
        bound_u=bound(n_all * lane_bytes, ops_u),
        bound_m=bound(n_all * (lane_bytes + 1), ops_m))


def partitioned_case_text(c):
    return (f"{c['label']} (N={c['n']}, lanes meeting each group "
            f"{c['lanes']}): pairs {c['pairs_m']:,} of {c['pairs_u']:,} "
            f"({c['pairs_m'] / c['pairs_u']:.3f}); unmasked "
            f"{c['ms_u']:.4f} ms, masked in launch order {c['ms_m']:.4f}, in "
            f"category order {c['ms_c']:.4f} ({c['ms_c'] / c['ms_u']:.3f} "
            f"of unmasked); bound unmasked {c['bound_u'][0]:.4f} ms "
            f"({c['bound_u'][1]}), masked {c['bound_m'][0]:.4f} "
            f"({c['bound_m'][1]}), category order at "
            f"{c['bound_m'][0] / c['ms_c']:.3f} of it")


def partition_phase(dev, kinds, reset_counts, counts, final_png,
                    random_png):
    """Phase 25: the partitioned sweep (the lanes' group masks in K1b and
    K1, the category-ordered compaction, ``--no-partition``); each render's
    bounces decided as the JAX package's rule decides on its probe's
    counts.  K1b on
    `final`'s bench chunk (400x225x16) bounces 0-2 and K1 on
    `sphereflake`'s 921,600 camera rays and their bounce-1 wave in sweep
    mode (``partitioned_sweep_case``); `sphereflake` rendered in sweep mode
    with and without the partition; `final`'s bench and the CLI default
    through the CLI with and without ``--no-partition`` (PNGs byte-equal
    to each other and to phases 9 and 4's, which ran partitioned by
    default; which bounces partitioned, the probe's category counts),
    `final`'s render profiled by layer both ways; the train CLI on
    `final` at bench_grad.py's shape both ways (the losses bit-equal),
    two partitioned steps from one state, and card against CPU gradients
    of a partitioned step.  Returns (the phase's line, the K1 and K1b
    records' partitioned keys)."""
    import contextlib
    import io

    from hyper_ray_tracer_tpu_torch import (
        RenderSettings,
        build_scene,
        render_image,
    )
    from hyper_ray_tracer_tpu_torch import render as render_mod
    from hyper_ray_tracer_tpu_torch.__main__ import main as cli_main
    from hyper_ray_tracer_tpu_torch.camera import make_basis
    from hyper_ray_tracer_tpu_torch.ops import partition
    from hyper_ray_tracer_tpu_torch.ops import rng as prng
    from hyper_ray_tracer_tpu_torch.ops.sphere_sweep import (
        sphere_sweep,
        sphere_sweep_plain,
    )
    from hyper_ray_tracer_tpu_torch.ops.typed_sweep import (
        typed_sweep,
        typed_sweep_plain,
    )
    from hyper_ray_tracer_tpu_torch.render import (
        WavefrontState,
        bounce_step,
        init_state,
    )
    from hyper_ray_tracer_tpu_torch.scene_tensors import to_device
    from hyper_ray_tracer_tpu_torch.train import main as train_main
    from hyper_ray_tracer_tpu_torch.utils.image import read_png
    from hyper_ray_tracer_tpu_torch.utils.profiling import counter

    t_phase = time.monotonic()

    def waves(scene, st, W, H, spp, depth):
        """The wavefronts of bounces 0..depth-1 (each bounce's survivors in
        launch order), with their bounce words."""
        ids = torch.arange(W * H * spp, dtype=torch.int64, device=dev)
        s = init_state(make_basis(scene.camera, W, H), W, H, ids % (W * H),
                       ids // (W * H), 0)
        out = []
        for b in range(depth):
            out.append((s, prng.bounce_base(s.base, b)))
            if b + 1 < depth:
                s = bounce_step(st, scene.background, s, b)
                keep = s.alive.nonzero().squeeze(1)
                s = WavefrontState(*(x.index_select(0, keep) for x in s))
        return out

    # K1b on `final`'s bench chunk, bounces 0-2.
    BW, BH, BSPP = PART_FINAL_SHAPE
    final = build_scene("final")
    final_t = to_device(final.arrays, final.static, dev)
    k1b = [partitioned_sweep_case(
        f"final bounce {b}", typed_sweep, typed_sweep_plain, final_t, s, bb,
        kinds, {}, 20) for b, (s, bb) in enumerate(
            waves(final, final_t, BW, BH, BSPP, 3))]
    # K1 on `sphereflake` in sweep mode: camera rays and their bounce 1.
    flake = build_scene("sphereflake")
    flake_t = to_device(flake.arrays, flake.static, dev)
    k1 = [partitioned_sweep_case(
        f"sphereflake {'camera' if b == 0 else 'bounce 1'}", sphere_sweep,
        sphere_sweep_plain, flake_t, s, None, kinds,
        {"groups": flake_t.groups}, 5) for b, (s, _) in enumerate(
            waves(flake, flake_t, *PART_FLAKE_RAYS, 1, 2))]
    cases_s = time.monotonic() - t_phase

    made = []  # every PartitionSchedule a render makes, in order

    class Recorded(render_mod.PartitionSchedule):
        def __init__(self, groups):
            super().__init__(groups)
            made.append(self)

    def sched_text(sched):
        on = [b for b, v in enumerate(sched.decisions) if v]
        return (f"bounces partitioned {on}, the probe's category counts by "
                f"bounce {sched.counts}")

    real_schedule = render_mod.PartitionSchedule
    render_mod.PartitionSchedule = Recorded
    try:
        # `sphereflake` in sweep mode, with and without the partition.
        flake_r = {}
        for flag in (True, False):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            img = render_image(flake, RenderSettings(
                *PART_FLAKE_RENDER, 10, intersector="sweep", partition=flag),
                dev)
            flake_r[flag] = (time.monotonic() - t0, img,
                             counts()["sphere_sweep"],
                             counter("K1.partitioned"))
        assert np.array_equal(flake_r[True][1], flake_r[False][1])
        assert flake_r[True][3] > 0 and flake_r[False][3] == 0, flake_r
        flake_sched = made[-1]

        # The CLI: `final`'s bench and the default, with and without
        # --no-partition.
        cli = {}
        with tempfile.TemporaryDirectory() as tmp:
            for name, argv in (
                    ("final", ["--scene", "final", "--width", str(BW),
                               "--height", str(BH), "--samples", str(BSPP),
                               "--depth", "10"]),
                    ("random", list(PART_RANDOM_ARGV))):
                for flag in ("", "--no-partition"):
                    out = Path(tmp) / f"{name}{flag}.png"
                    n_made = len(made)
                    reset_counts()
                    torch.cuda.synchronize()
                    t0 = time.monotonic()
                    rc = cli_main([*argv, *([flag] if flag else []),
                                   "--output", str(out)])
                    wall = time.monotonic() - t0
                    assert rc == 0, (name, flag, rc)
                    cli[name, flag] = dict(
                        wall=wall, png=read_png(out), launches=counts(),
                        partitioned=counter("K1b.partitioned")
                        + counter("K1.partitioned"),
                        sched=made[-1] if len(made) > n_made else None)
    finally:
        render_mod.PartitionSchedule = real_schedule
    for name, ref in (("final", final_png), ("random", random_png)):
        a, b = cli[name, ""], cli[name, "--no-partition"]
        assert np.array_equal(a["png"], b["png"]), name
        assert np.array_equal(a["png"], ref), name
        assert b["sched"] is None and b["partitioned"] == 0, name
    # Each bounce as the JAX package's rule decides on the probe's counts
    # (`random`'s last bounces pass it at the CLI default's shape).
    for name, n_prims in (("final", 1409), ("random", 486)):
        sched = cli[name, ""]["sched"]
        assert sched.decisions == [
            c is not None and partition.worth(c, sched.groups, n_prims)
            for c in sched.counts], (name, sched.decisions, sched.counts)
        assert (cli[name, ""]["partitioned"] > 0) == any(sched.decisions)
    assert any(cli["final", ""]["sched"].decisions)
    profiles = [render_profile(dev, "final", RenderSettings(
        BW, BH, BSPP, 10, partition=flag)) for flag in (True, False)]

    # The train CLI on `final` at bench_grad.py's shape, both ways.
    W, H, spp, depth = TRAIN_SHAPE
    train = {}
    for flag in ("", "--no-partition"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = train_main(["final", str(W), str(H), str(spp), str(depth),
                             *([flag] if flag else [])])
        assert rc == 0, f"train CLI exit code {rc}"
        train[flag] = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert train[""]["partition"] and train[""]["partitioned_bounces"]
    assert not train["--no-partition"]["partition"]
    assert train[""]["loss"] == train["--no-partition"]["loss"], train
    det = determinism_line(final, dev, TRAIN_SHAPE, partition=True)
    floor = partition.PART_MIN_LANES
    partition.PART_MIN_LANES = 1024  # so that phase 11's shape partitions
    try:
        grads = card_grad_check(final, dev, CARD_GRAD_SHARE["final"],
                                test_rule=False, partition=True)
    finally:
        partition.PART_MIN_LANES = floor
    total_s = time.monotonic() - t_phase

    def cli_text(name):
        a, b = cli[name, ""], cli[name, "--no-partition"]
        return (f"CLI {name}: wall {a['wall']:.3f} s partitioned, "
                f"{b['wall']:.3f} s with --no-partition, PNGs byte-equal "
                f"(and to phase {9 if name == 'final' else 4}'s); "
                f"{sched_text(a['sched'])}; launches {a['launches']} "
                f"({a['partitioned']} partitioned)")

    line = (
        "K1b masked vs its twin and vs unmasked K1b, bit-equal in t and "
        "prim on every lane (asserted): "
        + " | ".join(partitioned_case_text(c) for c in k1b)
        + " | K1 likewise: " + " | ".join(partitioned_case_text(c)
                                          for c in k1)
        + " | sphereflake {}x{}x{} d10 in sweep mode: render_image ".format(
            *PART_FLAKE_RENDER)
        + f"{flake_r[True][0]:.3f} s partitioned ({flake_r[True][3]} of "
        f"{flake_r[True][2]} K1 launches partitioned), "
        f"{flake_r[False][0]:.3f} s plain, images equal; "
        f"{sched_text(flake_sched)}"
        f" | {cli_text('final')} | {cli_text('random')}"
        f" | by layer, partitioned: {profiles[0]} | plain: {profiles[1]}"
        f" | train CLI final {W}x{H}x{spp} d{depth}: "
        f"{train['']['seconds_per_step']:.4f} s/step partitioned (bounces "
        f"{train['']['partitioned_bounces']}), "
        f"{train['--no-partition']['seconds_per_step']:.4f} s/step with "
        f"--no-partition, loss {train['']['loss']!r} both (asserted equal)"
        f" | partitioned steps: {det} | partitioned card vs CPU at 64x36 "
        f"2spp d4 (lane floor 1024): {grads}"
        f" | phase {total_s:.1f} s (its kernel cases {cases_s:.1f} s)")
    rec = {
        "typed_sweep": {
            "partitioned_launches": cli["final", ""]["partitioned"],
            "partitioned_ms": k1b[0]["ms_c"],
            "partitioned_bound_ms": k1b[0]["bound_m"][0],
            "partitioned_bound_by": k1b[0]["bound_m"][1],
            "partitioned_unmasked_ms": k1b[0]["ms_u"]},
        "sphere_sweep": {
            "partitioned_launches": cli["random", ""]["partitioned"],
            "partitioned_ms": k1[0]["ms_c"],
            "partitioned_bound_ms": k1[0]["bound_m"][0],
            "partitioned_bound_by": k1[0]["bound_m"][1],
            "partitioned_unmasked_ms": k1[0]["ms_u"]}}
    return line, rec


# The record_function ranges of render.trace_paths, and the hand kernels
# of a render by a substring of their names.
LAYERS = ("raygen", "trace", "shade", "compaction")
HAND = {"K1": ("sphere_sweep_kernel", "trace"),
        "K1b": ("typed_sweep_kernel", "trace"),
        "K2": ("noise_texture_kernel", "shade"),
        "K4": ("bvh_traverse_kernel", "trace"),
        "K5": ("cluster_sweep_kernel", "trace"),
        "K6": ("shade_kernel", "shade")}


def render_profile(dev, name, settings):
    """Where the device time of ``render_image`` goes: one warm-up, one
    unprofiled render timed, one under torch.profiler, its kernels' time
    given to the layers by the spans of render.trace_paths and to the
    hand kernels by name.  The time of K4 or K5 is also split by bounce
    (its launches in order, ``settings.depth`` a chunk), beside the lanes
    the trace kernels ran on (the port's ``<K>.lanes`` counters)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from hyper_ray_tracer_tpu_torch import build_scene, render_image
    from hyper_ray_tracer_tpu_torch.utils import profiling

    scene = build_scene(name)
    render_image(scene, settings, dev)  # warm-up
    t0 = time.monotonic()
    render_image(scene, settings, dev)  # ends with a copy to the host
    wall = (time.monotonic() - t0) * 1e3
    before = profiling.snapshot()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        render_image(scene, settings, dev)
    work = profiling.since(before)["counters"]
    events = prof.events()
    kern = [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.name not in LAYERS]
    head = (f"{name} {settings.width}x{settings.height}x{settings.samples} "
            f"d{settings.depth}: render_image {wall:.3f} ms")
    if not kern:
        return f"{head}; the profiler saw no device kernels"
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    span = (max(e.time_range.end for e in kern)
            - min(e.time_range.start for e in kern)) / 1e3
    by_layer = dict.fromkeys(LAYERS, 0.0)
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in by_layer:
            by_layer[e.name] += e.device_time_total / 1e3
    by_kernel = {k: sum(e.time_range.elapsed_us() for e in kern
                        if sub in e.name) / 1e3
                 for k, (sub, _) in HAND.items()}
    # The profiler links a kernel to the op that launched it; a hand
    # kernel, launched through ctypes, may have none, and then goes to
    # the range its wrapper runs in.
    linked = dict.fromkeys(HAND, 0.0)
    for e in events:
        for k in getattr(e, "kernels", ()):
            for h, (sub, _) in HAND.items():
                linked[h] += k.duration / 1e3 if sub in k.name else 0.0
    for h, (_, layer) in HAND.items():
        by_layer[layer] += by_kernel[h] - linked[h]
    text = (f"{head} unprofiled; profiled: {len(kern)} kernels busy "
            f"{busy:.3f} ms in a {span:.3f} ms span (idle "
            f"{1 - busy / span:.3f}; busy / unprofiled wall "
            f"{busy / wall:.3f}); busy ms by layer "
            + ", ".join(f"{k} {v:.3f}" for k, v in by_layer.items())
            + f" (layers hold {sum(by_layer.values()) / busy:.3f} of "
            f"busy); hand kernels "
            + ", ".join(f"{k} {v:.3f}" for k, v in by_kernel.items() if v))
    depth = settings.depth
    for hk in ("K4", "K5"):
        runs = sorted((e for e in kern if HAND[hk][0] in e.name),
                      key=lambda e: e.time_range.start)
        if runs and len(runs) % depth == 0:
            per = [sum(e.time_range.elapsed_us() for e in runs[b::depth])
                   / 1e3 for b in range(depth)]
            text += (f"; {hk} by bounce over {len(runs) // depth} chunks "
                     "(ms) " + "/".join(f"{v:.3f}" for v in per))
        elif runs:
            text += (f"; {hk} {len(runs)} launches, not {depth} a chunk: "
                     "not split by bounce")
    lanes = {hk: work.get(f"{hk}.lanes", 0) for hk in ("K1", "K1b", "K4",
                                                          "K5")}
    return text + (f"; trace lanes a camera ray "
                   f"{sum(lanes.values()) / work['camera_rays']:.3f} ("
                   + ", ".join(f"{k} {v}" for k, v in lanes.items() if v)
                   + f" lanes, {work['camera_rays']} camera rays)")


# Phase 26: multi-GPU through torch.distributed (the port's parallel/).
# Its workloads (scene, width, height, spp, depth): the render CLI's
# default, the bench workload, `sphereflake` in cluster mode, and
# bench_grad.py's train step.
PARALLEL_SIZES = {"cli": ("random", 1280, 720, 100, 10),
                  "bench": ("final", 400, 225, 16, 10),
                  "cluster": ("sphereflake", 640, 360, 4, 10),
                  "train": ("random", *TRAIN_SHAPE)}
# A sharded image against the single render, both at the gamma image: an
# spp-sharded mesh adds its ranks' partial sums in rank order, which moves
# the low bits (tests/test_sharding.py's bound on the JAX package).
SPP_SHARD_TOL = 2e-6
# Sharded gradients and losses against the single process's
# (tests/test_sharding.py's bound on the JAX package).
SHARD_GRAD_RTOL, SHARD_GRAD_ATOL = 1e-4, 1e-6
# The seconds a spawn of ranks may take before it is stopped.
SPAWN_TIMEOUT_S = 300


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def sharded_render_case(dev, wrappers, workload, intersector, shape, runs):
    """``runs`` renders of ``workload`` (PARALLEL_SIZES' form) through the
    sharded renderer on a mesh of ``shape``, started together on every
    rank (a barrier), each timed to its synchronised end: the first from
    before the scene's upload, as ``render_image``'s wall counts it, the
    others from the end of the one before.  The launch counts are set to
    0 before them and read after."""
    import hashlib

    import torch.distributed as dist

    from hyper_ray_tracer_tpu_torch import build_scene
    from hyper_ray_tracer_tpu_torch.camera import make_basis
    from hyper_ray_tracer_tpu_torch.parallel.mesh import make_render_mesh
    from hyper_ray_tracer_tpu_torch.parallel.render_sharded import (
        make_sharded_renderer,
    )

    name, W, H, spp, depth = workload
    scene = build_scene(name)
    mesh = make_render_mesh(*shape)
    sums, walls = [], []
    reset_launches(wrappers)
    dist.barrier()
    sync(dev)
    t0 = time.monotonic()
    st, mode = upload(scene, dev, intersector)
    run = make_sharded_renderer(scene, W, H, depth, mesh, mode)
    basis = make_basis(scene.camera, W, H)
    for _ in range(runs):
        total = run(st, basis, 0, spp, 0)
        sync(dev)
        walls.append(time.monotonic() - t0)
        sums.append(total.cpu().numpy())
        t0 = time.monotonic()
    sched = run.schedule()
    return dict(sums=sums if dist.get_rank() == 0 else None,
                digests=[hashlib.sha256(a.tobytes()).hexdigest()
                         for a in sums],
                walls=walls, launches=read_launches(wrappers),
                partitioned=(None if sched is None else
                             [b for b, on in enumerate(sched.decisions)
                              if on]))


def train_setup(scene, dev, workload):
    """(scene tensors, mode, a train step's arguments after the state):
    the whole launch of ``workload`` against a zero target."""
    from hyper_ray_tracer_tpu_torch.camera import make_basis
    from hyper_ray_tracer_tpu_torch.train import pixel_lanes

    _, W, H, spp, _ = workload
    st, mode = upload(scene, dev)
    return st, mode, (st, make_basis(scene.camera, W, H),
                      *pixel_lanes(W, H, spp, dev), 0,
                      torch.zeros((W * H, 3), device=dev))


def timed_steps(step, state, start, args, dev, n, barrier=None):
    """Seconds of ``n`` steps, each from the state ``start``
    (``train.restore``), each after ``barrier()`` when given."""
    from hyper_ray_tracer_tpu_torch.train import restore

    secs = []
    for _ in range(n):
        restore(state, start)
        if barrier is not None:
            barrier()
        sync(dev)
        t0 = time.monotonic()
        state, loss = step(state, *args)
        loss.item()
        secs.append(time.monotonic() - t0)
    return secs


def sharded_train_case(dev, wrappers, workload, shape, n_timed):
    """The sharded adam step on ``workload`` on a mesh of ``shape``: the
    first step's loss and folded gradients (the launch counts set to 0
    before it and read after), the parameters after a second step, then
    ``n_timed`` steps from the initial state, each started together on
    every rank."""
    import torch.distributed as dist

    from hyper_ray_tracer_tpu_torch import build_scene
    from hyper_ray_tracer_tpu_torch.parallel.mesh import make_render_mesh
    from hyper_ray_tracer_tpu_torch.parallel.render_sharded import (
        make_sharded_train_step,
    )
    from hyper_ray_tracer_tpu_torch.train import snapshot

    name, W, H, _, depth = workload
    scene = build_scene(name)
    st, mode, args = train_setup(scene, dev, workload)
    init, step = make_sharded_train_step(scene, W, H, depth,
                                         make_render_mesh(*shape), mode)
    state = init(st)
    start = snapshot(state)
    reset_launches(wrappers)
    state, loss = step(state, *args)
    sync(dev)
    launches = read_launches(wrappers)
    grads = {k: p.grad.cpu().numpy() for k, p in state.params.items()}
    state, _ = step(state, *args)
    params = {k: p.detach().cpu().numpy() for k, p in state.params.items()}
    return dict(loss=loss.item(), grads=grads, params=params,
                launches=launches,
                secs=timed_steps(step, state, start, args, dev, n_timed,
                                 dist.barrier))


def scaling_case(dev, wrappers, workload, reps):
    """``parallel.scaling.measure_scaling`` on ``workload``."""
    from hyper_ray_tracer_tpu_torch import build_scene
    from hyper_ray_tracer_tpu_torch.parallel.scaling import measure_scaling

    name, W, H, spp, depth = workload
    return dict(points=[dataclasses.asdict(p) for p in measure_scaling(
        build_scene(name), W, H, depth, spp, reps=reps, device=dev)])


PARALLEL_CASES = {"render": sharded_render_case, "train": sharded_train_case,
                  "scaling": scaling_case}


def parallel_rank(r, world, init_method, backend, devices, out_dir, cases):
    """A rank of phase 26, in a process of its own (``spawn_ranks``):
    starts the process group, runs ``cases`` (tuples: a key of
    ``PARALLEL_CASES`` and its arguments) in order and saves what they
    gave to ``out_dir``.  The kernels are loaded as the parent built
    them (``utils/cuda_build.py`` finds each library by its hash)."""
    from hyper_ray_tracer_tpu_torch.parallel.mesh import dist, init_distributed

    _, _, dev = init_distributed(devices[r], backend=backend,
                                 init_method=init_method, rank=r,
                                 world_size=world)
    try:
        wrappers = kernel_wrappers()
        out = [PARALLEL_CASES[c[0]](dev, wrappers, *c[1:]) for c in cases]
        torch.save(out, Path(out_dir) / f"rank{r}.pt")
    finally:
        dist.destroy_process_group()


def spawn_ranks(world, backend, devices, cases):
    """Run ``parallel_rank`` in ``world`` fresh processes (rank r on
    ``devices[r]``, a file rendezvous) and return each rank's results;
    raises if a rank fails, and stops them all after
    ``SPAWN_TIMEOUT_S``."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            parallel_rank, nprocs=world, join=False, start_method="spawn",
            args=(world, f"file://{tmp}/rendezvous", backend, devices, tmp,
                  cases))
        deadline = time.monotonic() + SPAWN_TIMEOUT_S
        try:
            while not ctx.join(timeout=5):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks ({backend}) still "
                                       f"running after {SPAWN_TIMEOUT_S} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.terminate()
                proc.join()
        return [torch.load(Path(tmp) / f"rank{r}.pt", weights_only=False)
                for r in range(world)]


def parallel_phase(dev, reset_counts, counts, smi, sizes=PARALLEL_SIZES):
    """Phase 26: the port's parallel/ on ``dev`` (``sizes``: the
    workloads).  (1) A group of one (nccl on a card): the CLI default
    through the sharded renderer on a 1x1 mesh, byte-equal to
    render_image's image; (2) two ranks on the one device under gloo
    (NCCL refuses two ranks on one card): the CLI default, `final` at the
    bench shape and `sphereflake` in cluster mode on a 2x1 rays mesh,
    byte-equal to the single render; the CLI default on a 1x2 spp mesh
    twice, within SPP_SHARD_TOL of it and byte-equal run to run; (3) the
    sharded train step on 2x1 and 1x2 meshes: the loss and gradients
    against the single process's, the parameters after two steps
    bit-equal across ranks, seconds a step beside the single step's;
    (4) on a machine with two cards or more, nccl across min(4, count)
    cards: the CLI default on an (n, 1) and an (n/2, 2) mesh, and the
    scaling points.  Returns the phase's text."""
    import os

    from hyper_ray_tracer_tpu_torch import RenderSettings, build_scene
    from hyper_ray_tracer_tpu_torch import render_image
    from hyper_ray_tracer_tpu_torch.camera import make_basis
    from hyper_ray_tracer_tpu_torch.parallel.collectives import gather_fold
    from hyper_ray_tracer_tpu_torch.parallel.mesh import (
        dist,
        init_distributed,
        make_render_mesh,
    )
    from hyper_ray_tracer_tpu_torch.parallel.render_sharded import (
        finish_image,
        make_sharded_renderer,
    )
    from hyper_ray_tracer_tpu_torch.render import gamma_image
    from hyper_ray_tracer_tpu_torch.train import make_train_step, snapshot

    # The ranks share this host: their rendezvous and NCCL's bootstrap go
    # over the loopback device.
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    t_phase = time.monotonic()
    cli = sizes["cli"]
    name, W, H, spp, depth = cli
    rays = W * H * spp

    def single(workload, intersector=None):
        """render_image's image and wall (the scene built before it, as
        the sharded cases build theirs before their timer)."""
        scene_name, W_, H_, spp_, depth_ = workload
        scene = build_scene(scene_name)
        sync(dev)
        t0 = time.monotonic()
        img = render_image(scene, RenderSettings(
            W_, H_, spp_, depth_, intersector=intersector), dev)
        return img, time.monotonic() - t0

    def label(workload):
        return "{} {}x{}x{} d{}".format(*workload)

    # (1) A group of one; a small render first, so that neither timed
    # render pays the process's first launches.
    single((name, 160, 90, 2, depth))
    ref, ref_s = single(cli)
    init_distributed(dev)
    try:
        backend = dist.get_backend()
        assert backend == ("nccl" if dev.type == "cuda" else "gloo"), backend
        scene = build_scene(name)
        sync(dev)
        reset_counts()
        t0 = time.monotonic()
        st, mode = upload(scene, dev)
        run = make_sharded_renderer(scene, W, H, depth,
                                    make_render_mesh(1, 1), mode)
        total = run(st, make_basis(scene.camera, W, H), 0, spp, 0)
        sync(dev)
        one_s = time.monotonic() - t0
        one_launches = counts()
        assert one_launches["sphere_sweep"] > 0, one_launches
        assert torch.equal(gather_fold(total, dist.group.WORLD), total)
        assert np.array_equal(gamma_image(total.cpu().numpy(), spp, W, H),
                              ref), "1x1 mesh: not byte-equal"
    finally:
        dist.destroy_process_group()
    text = (f"(1) {backend}, world 1, 1x1 mesh, {label(cli)}: byte-equal "
            f"to render_image; {one_s:.3f} s ({rays / one_s / 1e6:.3f} "
            f"Mrays/s) against render_image's {ref_s:.3f} s; K1 "
            f"{one_launches['sphere_sweep']} launches")

    # (2)-(3) Two ranks on the one device.  The single process's
    # references first, on a quiet device.
    bench, flake, train = sizes["bench"], sizes["cluster"], sizes["train"]
    bench_ref, bench_s = single(bench)
    flake_ref, flake_s = single(flake, "cluster")
    tscene = build_scene(train[0])
    _, tmode, targs = train_setup(tscene, dev, train)
    init, step = make_train_step(tscene, *train[1:3], train[4], tmode)
    state = init(targs[0])
    start = snapshot(state)
    state, loss = step(state, *targs)
    t_loss = loss.item()
    t_grads = {k: p.grad.cpu().numpy() for k, p in state.params.items()}
    t_secs = timed_steps(step, state, start, targs, dev, 3)
    cases = [("render", cli, "sweep", (2, 1), 1),
             ("render", bench, "sweep", (2, 1), 1),
             ("render", flake, "cluster", (2, 1), 1),
             ("render", cli, "sweep", (1, 2), 2),
             ("train", train, (2, 1), 3), ("train", train, (1, 2), 3)]
    t0 = time.monotonic()
    got = spawn_ranks(2, "gloo", [str(dev)] * 2, cases)
    spawn_s = time.monotonic() - t0

    def by_rank(c, *keys):
        return [tuple(g[c]["launches"][k] for k in keys) for g in got]

    def wall(c, run=0):
        return max(g[c]["walls"][run] for g in got)

    for c in range(4):
        for g in got[1:]:
            assert g[c]["digests"] == got[0][c]["digests"], cases[c]
    for c, want, kernels in ((0, ref, ("sphere_sweep",)),
                             (1, bench_ref, ("typed_sweep", "shade")),
                             (2, flake_ref, ("cluster_sweep",))):
        workload = cases[c][1]
        img = gamma_image(got[0][c]["sums"][0], workload[3], workload[1],
                          workload[2])
        assert np.array_equal(img, want), \
            f"2x1 mesh {label(workload)}: not byte-equal"
        for g in got:
            for k in kernels:
                assert g[c]["launches"][k] > 0, (workload, k, g[c])
    spp_mesh = got[0][3]
    assert spp_mesh["digests"][0] == spp_mesh["digests"][1], \
        "1x2 mesh: two runs differ"
    spp_err = float(np.abs(finish_image(spp_mesh["sums"][0].astype(
        np.float64), spp, W, H) - ref).max())
    assert spp_err <= SPP_SHARD_TOL, spp_err
    text += (f" | (2) gloo, 2 ranks on {dev} (spawned and joined in "
             f"{spawn_s:.1f} s), byte-equal to the single render on a 2x1 "
             f"mesh (walls from the scene's upload to the gathered sum, "
             f"as render_image's count): {label(cli)} {wall(0):.3f} s "
             f"({rays / wall(0) / 1e6:.3f} Mrays/s; single {ref_s:.3f} s), "
             f"K1 launches by rank {by_rank(0, 'sphere_sweep')}, "
             f"partitioned bounces by rank "
             f"{[g[0]['partitioned'] for g in got]}; {label(bench)} {wall(1):.3f} s (single {bench_s:.3f} s), "
             f"K1b / K6 launches by rank "
             f"{by_rank(1, 'typed_sweep', 'shade')}, partitioned "
             f"bounces by rank {[g[1]['partitioned'] for g in got]}; "
             f"{label(flake)} in cluster mode {wall(2):.3f} s (single "
             f"{flake_s:.3f} s), K5 launches by rank "
             f"{by_rank(2, 'cluster_sweep')}; 1x2 spp mesh {label(cli)}: "
             f"two runs byte-equal ({wall(3, 0):.3f}, {wall(3, 1):.3f} s), "
             f"max |gamma - single| {spp_err:.3e} (bound {SPP_SHARD_TOL})")

    for c in (4, 5):
        shape = cases[c][2]
        res = [g[c] for g in got]
        for r in res[1:]:
            for k, v in r["params"].items():
                assert np.array_equal(v, res[0]["params"][k]), \
                    f"train {shape}: parameter {k} differs across ranks"
        worst = 0.0
        for r in res:
            np.testing.assert_allclose(r["loss"], t_loss,
                                       rtol=SHARD_GRAD_RTOL,
                                       atol=SHARD_GRAD_ATOL)
            for k, want in t_grads.items():
                np.testing.assert_allclose(
                    r["grads"][k], want, rtol=SHARD_GRAD_RTOL,
                    atol=SHARD_GRAD_ATOL, err_msg=f"train {shape} {k}")
                worst = max(worst, float(np.abs(r["grads"][k] - want).max()))
            assert r["launches"]["sphere_sweep"] > 0 \
                and r["launches"]["segment_sum"] > 0, r["launches"]
        step_s = min(max(r["secs"][i] for r in res)
                     for i in range(len(res[0]["secs"])))
        text += (f" | (3) sharded train step {label(train)} on a "
                 f"{shape[0]}x{shape[1]} mesh: loss {res[0]['loss']:.9f} "
                 f"(single {t_loss:.9f}), gradients within rtol "
                 f"{SHARD_GRAD_RTOL} atol {SHARD_GRAD_ATOL} (max |diff| "
                 f"{worst:.3e}), parameters bit-equal across ranks after two "
                 f"steps; {step_s:.4f} s a step (single {min(t_secs):.4f} "
                 f"s); K1 / K3 launches a step by rank "
                 f"{by_rank(c, 'sphere_sweep', 'segment_sum')}")

    # (4) Several cards.
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if n_cards < 2:
        text += (f" | (4) several cards: this machine has {n_cards}; nccl "
                 "across cards needs two or more and did not run")
    else:
        n = min(4, n_cards)
        shapes = [(n, 1), (n // 2, 2)]
        cases = [("render", cli, "sweep", sh, 1) for sh in shapes] \
            + [("scaling", cli, 2)]
        t0 = time.monotonic()
        got = spawn_ranks(n, "nccl", [f"cuda:{r}" for r in range(n)], cases)
        spawn_s = time.monotonic() - t0
        parts = []
        for c, sh in enumerate(shapes):
            for g in got[1:]:
                assert g[c]["digests"] == got[0][c]["digests"], sh
            total = got[0][c]["sums"][0]
            if sh[1] == 1:
                assert np.array_equal(gamma_image(total, spp, W, H), ref), \
                    f"nccl {sh}: not byte-equal"
                err = 0.0
            else:
                err = float(np.abs(finish_image(total.astype(np.float64),
                                                spp, W, H) - ref).max())
                assert err <= SPP_SHARD_TOL, (sh, err)
            parts.append(f"{sh[0]}x{sh[1]} {wall(c):.3f} s "
                         f"({rays / wall(c) / 1e6:.3f} Mrays/s), max |gamma "
                         f"- single| {err:.3e}")
        points = got[0][len(shapes)]["points"]
        text += (f" | (4) nccl across {n} cards (spawned and joined in "
                 f"{spawn_s:.1f} s), {label(cli)}: " + "; ".join(parts)
                 + "; scaling (best of 2) "
                 + ", ".join(f"{p['n_devices']} cards {p['seconds']:.3f} s "
                             f"{p['mrays_per_s']:.3f} Mrays/s efficiency "
                             f"{p['efficiency']:.3f}" for p in points))
    return (f"multi-GPU ({'; '.join(smi.splitlines())}; "
            f"{time.monotonic() - t_phase:.1f} s): " + text)


# Phase 27: K1b's bf16 form.  The camera rays it is held to its twin on
# (the bench's and the images' shapes; `sphereflake` in sweep mode at the
# CLI default's 1280x720), and the images whose drift it reports.
BF16_RAYS = (("three-spheres", 320, 180, 16), ("final", 400, 225, 16),
             ("sphereflake", 1280, 720, 1))
BF16_IMAGES = (("three-spheres", 320, 180, 16, 10),
               ("final", 400, 225, 16, 10))
BF16_FLAKE_RENDER = (640, 360, 4, 10)
# The bf16 form's operations per ray-primitive pair of a bf16 tile
# (csrc/typed_sweep.cu fold_sphere_pair_bf16): float32, oc's 3
# differences and the dots half_b and oc.oc, 5 each (a product and two
# FFMAs); bf16, c 1 (r^2 is the record's), disc 3 and the test 1.  Per
# ray once: a's 5 float32 and 1/a's division.  The roots, as in
# SWEEP_PAIR_OPS, are left out.  bf16 at the card's packed rate: 133.8
# TFLOP/s of bf16 outside the tensor cores on the H100 SXM, twice the
# FP32 rate (NVIDIA H100 Tensor Core GPU Architecture white paper, table
# of peak rates: "Peak BF16 (non-Tensor)").
BF16_PAIR_OPS = {"fp32": 13, "bf16": 5}
BF16_RAY_OPS = {"fp32": 6, "bf16": 0}
BF16_OPS_S = 133.8e12
# The bf16 form's earlier design, which ran in the float32 kernel's
# launch shape (4 rays a thread, 5 blocks), as measured on an H100 80GB
# HBM3 at 700 W (PERF.md, the K1b bf16 row): its pair loop's SASS and
# ptxas report, printed beside this loop's.
BF16_EARLIER = ("23.38 instructions a pair, 6.88 unpacks (55 of a trip's "
             "187), 4 FFMAs; 96-100 registers, 100 B spilled")
# A SASS instruction that moves one bf16 half into a float32's place: a
# shift by 16, or the high half masked or permuted over a zero register.
BF16_UNPACK = re.compile(r"^(IMAD(\.SHL)?\.U32 \S+, \S+, 0x10000, RZ|"
                         r"SHF\.L\.U32 \S+, \S+, 0x10, RZ|"
                         r"LOP3\.LUT \S+, \S+, 0xffff0000, RZ|"
                         r"PRMT \S+, (\S+, 0x\w+, RZ|RZ, 0x\w+, \S+))")


def bf16_pair_shares(sw, o, d, warps=64, seed=0):
    """On ``warps`` runs of 32 consecutive rays of ``o``, ``d`` (drawn
    from ``seed``): the share of (ray, sphere) pairs of the bf16 tiles
    whose bf16 discriminant is >= 0 (the twin's arithmetic), and the
    share of (32 rays, 2 consecutive spheres) blocks with at least one:
    the trips where a warp of the kernel takes a ray's roots branch."""
    from hyper_ray_tracer_tpu_torch.ops.typed_sweep import (
        bf16_ray_terms,
        bf16_tile,
        dot3_bf16,
    )

    gen = torch.Generator().manual_seed(seed)
    starts = torch.randint(0, o.shape[0] // 32, (warps,), generator=gen)
    lanes = (starts[:, None] * 32 + torch.arange(32)).reshape(-1)
    lanes = lanes.to(o.device)
    o, d = o[lanes][:, None], d[lanes][:, None]
    d16, a16, _ = bf16_ray_terms(d)
    bf = torch.bfloat16
    pairs = ok = blocks = blocks_ok = 0
    for t in sw.plan:
        if not bf16_tile(t):
            continue
        for s0 in range(t.start, t.start + t.width, 512):
            rec = sw.geo16[s0:min(s0 + 512, t.start + t.width)]
            oc = (o - rec[None, :, :3]).to(bf)
            hb = dot3_bf16(oc, d16)
            disc = hb * hb - a16 * (dot3_bf16(oc, oc) - rec[None, :, 3]
                                    .to(bf))
            hit = disc >= 0
            pairs += hit.numel()
            ok += int(hit.sum())
            w = hit.shape[1] // 2 * 2
            blk = hit[:, :w].reshape(warps, 32, w // 2, 2).any(3).any(1)
            blocks += blk.numel()
            blocks_ok += int(blk.sum())
    return ok / pairs, blocks_ok / blocks


def bf16_bound(sw, kinds, n):
    """(bound_ms, bound_by) of the bf16 form on ``n`` rays over the plan of
    ``sw``: its float32 tiles by ``sweep_fp_ops``' counts, its bf16 tiles
    by BF16_PAIR_OPS, each kind of operation over its rate; bytes as the
    float32 sweep's (45 a ray)."""
    from hyper_ray_tracer_tpu_torch.ops.typed_sweep import bf16_tile

    f32 = sw._replace(plan=tuple(t for t in sw.plan if not bf16_tile(t)))
    low = sum(t.width for t in sw.plan if bf16_tile(t))
    fp32 = (sweep_fp_ops(f32, kinds) if f32.plan else 0) \
        + low * BF16_PAIR_OPS["fp32"] + BF16_RAY_OPS["fp32"]
    bf16 = low * BF16_PAIR_OPS["bf16"] + BF16_RAY_OPS["bf16"]
    times = {"bytes": n * 45 / HBM_BYTES_S,
             "operations": n * (fp32 / FP32_OPS_S + bf16 / BF16_OPS_S)}
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def bf16_phase(dev, kinds, reset_counts, counts, probe_sass=None,
               shape=(2, 6), reps=3, ptxas=None):
    """Phase 27: K1b's bf16 form against its twin, bit for bit, unmasked
    and (on scenes with partition groups) masked, on the camera rays of
    BF16_RAYS, with the share of lanes whose winner differs from the
    float32 sweep's; K1b bf16, K1b float32 and K1 timed on `sphereflake`'s
    camera rays beside the bf16 form's bound, with the share of pairs
    whose bf16 discriminant is >= 0 there (``bf16_pair_shares``); the
    images of BF16_IMAGES with and without bf16_hits (mean |dI|),
    `sphereflake` in sweep mode both ways (its mean radiance, a finding);
    with ``probe_sass`` (the SASS of csrc/sweep_probe.cu), the bf16 pair
    loop's instructions by opcode (``shape``: the form's rays a thread and
    pairs of spheres a trip), and with ``ptxas`` (the reports of
    typed_sweep and sweep_probe) its registers and spills, asserted 0;
    first, its MUFU square root against the correctly rounded one on
    every non-negative bf16 value.  Returns (text, the kernels-line
    record)."""
    from hyper_ray_tracer_tpu_torch import RenderSettings, build_scene
    from hyper_ray_tracer_tpu_torch.camera import make_basis
    from hyper_ray_tracer_tpu_torch.ops import partition
    from hyper_ray_tracer_tpu_torch.ops import rng as prng
    from hyper_ray_tracer_tpu_torch.ops.sphere_sweep import sphere_sweep
    from hyper_ray_tracer_tpu_torch.ops.typed_sweep import (
        bf16_engages,
        bf16_sqrt,
        bf16_sqrt_plain,
        bf16_tile,
        typed_sweep,
        typed_sweep_plain,
    )
    from hyper_ray_tracer_tpu_torch.render import init_state, render_image

    texts, record = [], {}
    rays, pairs = shape
    # The roots' MUFU square root on every non-negative bf16 value, +0 to
    # +inf, against the correctly rounded one (tests/test_torch_cuda.py
    # test_bf16_sqrt_equals_plain_on_every_bf16).
    words = np.arange(1 << 15, dtype=np.uint32) << 16
    x = torch.from_numpy(words.view(np.float32))
    x = x[~torch.isnan(x)]
    assert torch.equal(bf16_sqrt(x.to(dev)).cpu(), bf16_sqrt_plain(x))
    texts.append(f"MUFU square root equal to the correctly rounded one "
                 f"on all {x.numel()} non-negative bf16 values (asserted)")
    if ptxas is not None:
        own = {k: v for rep in ptxas for k, v in rep.items()
               if k in (f"typed_sweep_kernel<{rays},1>",
                        f"fold_probe_bf16<{rays}>")}
        assert len(own) == 2 and all(v[2] == 0 for v in own.values()), own
        texts.append(f"its own kernel ({rays} rays a thread, {pairs} pairs "
                     f"of spheres a trip): " + "; ".join(
                         f"{k} {r} registers, {sp} B spilled"
                         for k, (r, _, sp, _) in own.items())
                     + " (0 spilled, asserted)")
    if probe_sass is not None:
        # The code every trip issues (the roots' branch aside: there the
        # square root's own FFMA refinement): no HFMA2 whose three
        # operands are all registers (a product and a sum fused; nvcc
        # writes a bf16 add as HFMA2 by 1 and a move as HFMA2.MMA of
        # zeros), and no FFMA but the dots' two each, which add products
        # exact in float32.
        ops, code = {}, []
        trip = 2 * rays * pairs
        per = sass_pair_ops(probe_sass, "fold_probe_bf16", trip, ops, code)
        fused = [c for c in code if c.startswith("HFMA2")
                 and not re.search(r"(-?RZ|\b-?[0-9.]+\b|0x[0-9a-f]+)"
                                   r"(,|$)", c.split(None, 1)[1])]
        assert not fused, fused
        ffma = sum(c.startswith("FFMA") for c in code)
        assert ffma <= 4 * trip, (ffma, code)
        unpacks = sum(bool(BF16_UNPACK.match(c)) for c in code)
        texts.append(
            f"SASS of the bf16 pair loop ({2 * pairs} spheres x {rays} "
            f"rays a trip): {per['all']:.2f} instructions a ray-sphere "
            f"pair ({per['branch']:.2f} more where a root is taken), "
            f"{ffma / trip:.2f} FFMAs (the dots', at most 4, asserted) and "
            f"{unpacks / trip:.2f} unpacks of bf16 to float32 a pair; no "
            "fused HFMA2; by opcode "
            + ", ".join(f"{k} {v}" for k, v in sorted(ops.items()))
            + f" (the earlier design: {BF16_EARLIER})")
    for name, W, H, spp in BF16_RAYS:
        scene = build_scene(name)
        st, _ = upload(scene, dev, "sweep")
        assert bf16_engages(st.sweep), name
        pix = torch.arange(W * H, dtype=torch.int64, device=dev).repeat(spp)
        sam = torch.arange(spp, dtype=torch.int64,
                           device=dev).repeat_interleave(W * H)
        s = init_state(make_basis(scene.camera, W, H), W, H, pix, sam, 0)
        bits = prng.bounce_base(s.base, 0)
        args = (st.sweep, s.o, s.d, s.time, s.alive, bits, T_MIN)
        t_k, b_k = typed_sweep(*args, bf16=True)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        t_p, b_p = typed_sweep_plain(*args, bf16=True)
        torch.cuda.synchronize()
        plain_ms = (time.monotonic() - t0) * 1e3
        assert torch.equal(t_k, t_p) and torch.equal(b_k, b_p), name
        masked = ""
        if st.groups:
            # A bf16 candidate can pass where the ray misses the group's
            # float32 box, which the mask then leaves out: the masked form
            # is held to the masked twin.
            mask = partition.group_mask(st.groups, s.o, s.d, st.group_aabbs)
            t_m, b_m = typed_sweep(*args, mask=mask, bf16=True)
            t_q, b_q = typed_sweep_plain(*args, mask=mask, bf16=True)
            assert torch.equal(t_m, t_q) and torch.equal(b_m, b_q), name
            masked = (f", masked too (the masked winner differs from the "
                      f"unmasked on {int((b_m != b_k).sum())} lanes: bf16 "
                      f"hits outside a group's box)")
        t_f, b_f = typed_sweep(*args)
        n = s.o.shape[0]
        changed = int((b_f != b_k).sum())
        low = sum(t.width for t in st.sweep.plan if bf16_tile(t))
        texts.append(f"{name} {W}x{H}x{spp} ({n} rays, {low} of "
                     f"{st.static.n_prims} primitives in bf16 tiles): "
                     f"bit-equal to the twin{masked}; winner differs from "
                     f"float32 on {changed} lanes ({changed / n:.3e})")
        if name == "sphereflake":
            k1b16 = device_ms(lambda *a: typed_sweep(*a, bf16=True), args,
                              reps)
            k1b32 = device_ms(lambda *a: typed_sweep(*a), args, reps)
            k1 = device_ms(sphere_sweep, (*st.spheres, s.o, s.d, s.time,
                                          s.alive, T_MIN), reps)
            bnd = bf16_bound(st.sweep, kinds, n)
            b32 = bound(n * 45, n * sweep_fp_ops(st.sweep, kinds))
            share, blocks = bf16_pair_shares(st.sweep, s.o, s.d)
            record = dict(ms=k1b16, plain_ms=plain_ms, bound_ms=bnd[0],
                          bound_by=bnd[1],
                          max_abs_err=float((t_k - t_p).abs().max()))
            texts.append(
                f"sphereflake camera rays: K1b bf16 {k1b16:.4f} ms, K1b "
                f"float32 {k1b32:.4f}, K1 {k1:.4f} (device time, {reps} "
                f"each); the bf16 form's bound {bnd[0]:.4f} ms ({bnd[1]}; "
                f"{bnd[0] / k1b16:.3f} of it), float32's {b32[0]:.4f} "
                f"({b32[1]}); its twin {plain_ms:.1f} ms; bf16 "
                f"discriminant >= 0 on {share:.4%} of the pairs, in "
                f"{blocks:.4%} of the (32 rays, 2 spheres) blocks (64 "
                "runs of 32 rays)")
    for name, W, H, spp, depth in BF16_IMAGES:
        scene = build_scene(name)
        base = dict(width=W, height=H, samples=spp, depth=depth)
        img32 = render_image(scene, RenderSettings(**base), dev)
        reset_counts()
        img16 = render_image(scene, RenderSettings(**base, bf16_hits=True),
                             dev)
        c = counts()
        assert c["typed_sweep_bf16"] > 0, (name, c)
        if name == "final":
            record["launches"] = c["typed_sweep_bf16"]
        assert np.isfinite(img16).all()
        texts.append(f"{name} {W}x{H}x{spp} d{depth}: mean |dI| bf16 vs "
                     f"float32 {np.abs(img16 - img32).mean():.6f} (K1b bf16 "
                     f"launches {c['typed_sweep_bf16']}, K1 "
                     f"{c['sphere_sweep']})")
    W, H, spp, depth = BF16_FLAKE_RENDER
    flake = build_scene("sphereflake")
    base = dict(width=W, height=H, samples=spp, depth=depth,
                intersector="sweep")
    m32 = render_image(flake, RenderSettings(**base), dev)
    m16 = render_image(flake, RenderSettings(**base, bf16_hits=True), dev)
    lin32, lin16 = (np.square(x.astype(np.float64)) for x in (m32, m16))
    dI = np.abs(m16 - m32)
    texts.append(f"sphereflake {W}x{H}x{spp} d{depth} sweep mode: mean "
                 f"radiance float32 {lin32.mean():.6f}, bf16 "
                 f"{lin16.mean():.6f}; mean |dI| {dI.mean():.6f}; pixels "
                 f"differing by more than 0.1: "
                 f"{int((dI.max(-1) > 0.1).sum())} of {W * H}")
    return " | ".join(texts), record


# F6: phase 20's `sphereflake-small` shape (64x36x2 d4), whose lanes
# parted between the card and the CPU (ROADMAP F6).
F6_SHAPE = (64, 36, 2, 4)


def f6_pin(dev):
    """F6's repair on the card: `sphereflake-small`'s camera rays at phase
    20's 64x36x2 bit-equal to the CPU's (asserted), and the lanes' x +
    jitter that a division by the Python number 63 rounds otherwise on
    the card than on the CPU (tests/test_torch_cuda.py
    test_camera_rays_on_card_equal_cpu)."""
    from hyper_ray_tracer_tpu_torch import build_scene
    from hyper_ray_tracer_tpu_torch.camera import make_basis
    from hyper_ray_tracer_tpu_torch.ops.math import div_rn
    from hyper_ray_tracer_tpu_torch.render import init_state
    from hyper_ray_tracer_tpu_torch.train import pixel_lanes

    x = torch.tensor([28.065364837646484, 40.71052551269531,
                      27.839258193969727, 22.632497787475586])
    scalar = int(((x.to(dev) / 63.0).cpu() != x / 63.0).sum())
    assert torch.equal(div_rn(x.to(dev), 63.0).cpu(), x / 63.0)
    scene = build_scene("sphereflake-small")
    W, H, spp, _ = F6_SHAPE
    basis = make_basis(scene.camera, W, H)
    pix, sam = (t.reshape(-1) for t in pixel_lanes(W, H, spp, dev))
    card = init_state(basis, W, H, pix, sam, 0)
    cpu = init_state(basis, W, H, pix.cpu(), sam.cpu(), 0)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(card, cpu))
    return (f"the four lanes' x + jitter over 63: {scalar} of 4 an ulp off "
            f"the CPU's as x / 63.0 on the card, none through div_rn; "
            f"sphereflake-small's {W * H * spp} camera rays bit-equal card "
            f"vs CPU (asserted); the lanes still parting: phase 20's line")


# Phase 28: K6 at the main path's shape, a chunk of the CLI default
# (1280x720, 9 spp: 8,294,400 lanes), on the two benchmark scenes.
K6_SHAPE = (1280, 720, 9)
# Bytes a lane K6 must move (csrc/shade.cu's contract): it reads o, d
# (24), the bounce word (8), t and prim (8), alive (1), throughput and
# radiance (24), and time (4) in a scene with motion; it writes o, d,
# throughput, radiance (48) and alive (1).  The winners' rows and the
# texels stay in L1 and L2 and are not counted.
K6_LANE_BYTES = 65 + 49
K6_MOTION_BYTES = 4


def k6_phase(dev, ptxas_note):
    """K6 (``ops/shade.shade_lanes``) against its plain version, the
    eager ``render.shade_hits`` (``fused_shading`` held false), on the
    same inputs: bounces 0-2 of a ``K6_SHAPE`` chunk of `final` and of
    `sphereflake` (its BVH order), each bounce's o, d, throughput,
    radiance and alive bit-equal (asserted), the next bounce from the
    eager survivors.  Times: K6's kernel on the device (``device_ms``),
    both paths a call in turns, and K6's byte bound.  Returns (text,
    record of `final`'s bounce 0 for the kernels line)."""
    from hyper_ray_tracer_tpu_torch import build_scene
    from hyper_ray_tracer_tpu_torch import render as R
    from hyper_ray_tracer_tpu_torch.camera import make_basis
    from hyper_ray_tracer_tpu_torch.ops import rng as prng
    from hyper_ray_tracer_tpu_torch.ops.shade import shade_lanes
    from hyper_ray_tracer_tpu_torch.scene_tensors import to_device

    W, H, spp = K6_SHAPE
    pix = torch.arange(W * H, dtype=torch.int64, device=dev).repeat(spp)
    smp = torch.arange(spp, dtype=torch.int64,
                       device=dev).repeat_interleave(W * H)
    fused = R.fused_shading
    sky = (R._SKY_WHITE, R._SKY_BLUE)
    texts, record = [], None
    for name in ("final", "sphereflake"):
        scene = build_scene(name)
        arrays, structure, mode = R.prepare_scene(scene, None)
        st = to_device(arrays, scene.static, dev, structure)
        state = R.init_state(make_basis(scene.camera, W, H), W, H, pix, smp,
                             3)
        lane_bytes = K6_LANE_BYTES + (K6_MOTION_BYTES
                                      if scene.static.has_motion else 0)
        rows = []
        for b in range(3):
            bb = prng.bounce_base(state.base, b)
            t_hit, prim = R.trace(st, state, bb)
            args = (st, state.o, state.d, state.time, bb, t_hit, prim,
                    state.alive, state.throughput, state.radiance,
                    scene.background, sky)

            def eager(*_):
                R.fused_shading = lambda *a: False
                try:
                    return R.shade_hits(st, scene.background, state, bb,
                                        t_hit, prim)
                finally:
                    R.fused_shading = fused

            o, d, alive, thr, rad = shade_lanes(*args)
            ref = eager()
            assert torch.equal(alive, ref.alive), (name, b, "alive")
            for f, x in (("o", o), ("d", d), ("throughput", thr),
                         ("radiance", rad)):
                assert torch.equal(x.view(torch.int32),
                                   getattr(ref, f).view(torch.int32)), \
                    (name, b, f)
            ms = device_ms(shade_lanes, args, 20, only=("shade_kernel",))
            call_ms, plain_ms = in_turns(eager, shade_lanes, args, 3, 20)
            n = state.o.shape[0]
            bnd = bound(n * lane_bytes, 0)
            rows.append((b, n, ms, call_ms, plain_ms, bnd))
            if name == "final" and b == 0:
                record = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bnd[0],
                          "bound_by": bnd[1]}
            keep = ref.alive.nonzero().squeeze(1)
            state = R.WavefrontState(*(x.index_select(0, keep) for x in ref))
        texts.append(f"{name} ({mode}, {lane_bytes} B a lane): " + "; ".join(
            f"bounce {b} {n} lanes: K6 {ms:.4f} ms on the device ({call:.4f}"
            f" ms a call), eager {plain:.4f} ms a call ({plain / call:.1f}x),"
            f" bound {bnd[0]:.4f} ms ({bnd[1]}), {bnd[0] / ms:.3f} of it"
            for b, n, ms, call, plain, bnd in rows))
    return (f"K6 vs the eager shade_hits on the card, bounces 0-2 of a "
            f"{W}x{H}x{spp} chunk, bit-equal in o, d, throughput, radiance "
            f"and alive (asserted): " + " | ".join(texts)
            + f"; ptxas: {ptxas_note}"), record


def kernel_wrappers():
    """Each hand kernel's wrapper by name, with the tag its launches are
    counted under in the port's registry (``utils/profiling.py``:
    ``<tag>.launches``)."""
    return {"sphere_sweep": "K1", "typed_sweep": "K1b", "turbulence": "K2",
            "turbulence_bwd": "K2b", "segment_sum": "K3",
            "bvh_traverse": "K4", "cluster_sweep": "K5", "shade": "K6"}


def reset_launches(wrappers):
    """Clear the port's counters (and span totals)."""
    from hyper_ray_tracer_tpu_torch.utils import profiling

    profiling.reset()


def read_launches(wrappers):
    """Each wrapper's launches since ``reset_launches``, and those of
    K1b's bf16 form."""
    from hyper_ray_tracer_tpu_torch.utils.profiling import counter

    return {**{name: counter(f"{tag}.launches")
               for name, tag in wrappers.items()},
            "typed_sweep_bf16": counter("K1b.bf16")}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", metavar="DIR",
                    help="a checkout of the parent commit: phase 15 then "
                         "times its K3 design in turns with this one")
    ap.add_argument("--only-parallel", action="store_true",
                    help="build the kernels and run phase 26 alone (no "
                         "result line): the multi-GPU phase on a machine "
                         "with several cards")
    ap.add_argument("--only-bf16", action="store_true",
                    help="build the kernels and run phase 27 alone (no "
                         "result line)")
    ap.add_argument("--only-shade", action="store_true",
                    help="build the kernels and run phase 28 alone (no "
                         "result line)")
    args = ap.parse_args(argv)
    parent = args.parent
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from hyper_ray_tracer_tpu_torch import RenderSettings, build_scene
    from hyper_ray_tracer_tpu_torch import prepare_scene, render_image
    from hyper_ray_tracer_tpu_torch.__main__ import main as cli_main
    from hyper_ray_tracer_tpu_torch.camera import make_basis
    from hyper_ray_tracer_tpu_torch.models.bvh_build import build_bvh
    from hyper_ray_tracer_tpu_torch.models.scene import (
        PT_BOX,
        PT_MEDIUM_BOX,
        PT_MEDIUM_SPHERE,
        PT_RECT,
        PT_SPHERE,
        TT_NOISE,
        TT_SOLID,
    )
    from hyper_ray_tracer_tpu_torch.ops import rng as prng
    from hyper_ray_tracer_tpu_torch.ops.intersect import (
        gather_prim_shade_packed,
        hit_detail,
    )
    from hyper_ray_tracer_tpu_torch.ops.sphere_sweep import (
        sphere_sweep,
        sphere_sweep_plain,
    )
    from hyper_ray_tracer_tpu_torch.ops.turbulence import (
        noise_texture,
        noise_texture_plain,
    )
    from hyper_ray_tracer_tpu_torch.ops.typed_sweep import (
        typed_sweep,
        typed_sweep_plain,
    )
    from hyper_ray_tracer_tpu_torch.render import (
        bounce_step,
        init_state,
        trace,
    )
    from hyper_ray_tracer_tpu_torch.scene_tensors import to_device
    from hyper_ray_tracer_tpu_torch.utils import cuda_build
    from hyper_ray_tracer_tpu_torch.utils.image import read_png
    from hyper_ray_tracer_tpu_torch.utils.profiling import counter

    dev = torch.device("cuda")
    kinds = {PT_SPHERE: "sphere", PT_MEDIUM_SPHERE: "sphere", PT_RECT: "rect",
             PT_BOX: "box", PT_MEDIUM_BOX: "box"}
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    wrappers = kernel_wrappers()

    def reset_counts():
        reset_launches(wrappers)

    def counts():
        return read_launches(wrappers)

    # Phase 1: device and kernel builds, one nvcc per source, all at once.
    t0 = time.monotonic()
    sources = KERNELS + (PROBES,)
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(cuda_build.build, sources)))
    build_s = time.monotonic() - t0
    ptxas = {name: ptxas_report(Path(str(lib) + ".log").read_text())
             for name, lib in libs.items()}

    def resources(report):
        return "; ".join(f"{k} {r} registers, {sm} B static smem, {sp} B "
                         f"spilled, {fr} B stack frame"
                         for k, (r, sm, sp, fr) in report.items())

    notes = []
    for name in KERNELS:
        cuda_build.load(name)
        notes.append(f"{name}: {resources(ptxas[name])}")
    # K4 walks a stack in local memory by design, and spills nothing; nor
    # do K3, K5 and K6.
    for name in ("bvh_traverse", "segment_sum", "cluster_sweep", "shade"):
        assert all(r[2] == 0 for r in ptxas[name].values()), \
            f"{name} spills: {ptxas[name]}"
    # The sweeps' ray-packet size R (rays per thread), the header's kRays.
    packet = int(re.search(r"constexpr int kRays = (\d+);", (
        cuda_build.CSRC_DIR / "sweep_sphere.cuh").read_text()).group(1))
    # K1b's bf16 form's own: rays a thread and pairs of spheres a trip.
    typed_src = (cuda_build.CSRC_DIR / "typed_sweep.cu").read_text()
    bf16_shape = tuple(int(re.search(rf"constexpr int {k} = (\d+);",
                                     typed_src).group(1))
                       for k in ("kBf16Rays", "kBf16Pairs"))
    bf16_ptxas = (ptxas["typed_sweep"], ptxas[PROBES])
    cuobjdump = Path(cuda_build.find_nvcc()).parent / "cuobjdump"

    def sass_of(name):
        return subprocess.run([str(cuobjdump), "-sass", str(libs[name])],
                              capture_output=True, text=True, timeout=120,
                              check=True).stdout

    phase(1, f"device {kind!r} count {torch.cuda.device_count()} | "
          f"nvidia-smi: {smi} | {len(sources)} sources ({', '.join(sources)})"
          f" built in {build_s:.2f} s | " + " | ".join(notes))
    if args.only_bf16:
        phase(27, bf16_phase(dev, kinds, reset_counts, counts,
                             sass_of(PROBES), bf16_shape,
                             ptxas=bf16_ptxas)[0]
              + " | F6: " + f6_pin(dev))
        print(smi)
        print("chip_smoke --only-bf16: phases 2-26 not run; no result")
        return 0
    if args.only_shade:
        phase(28, k6_phase(dev, resources(ptxas["shade"]))[0])
        print(smi)
        print("chip_smoke --only-shade: phases 2-27 not run; no result")
        return 0
    if args.only_parallel:
        phase(26, parallel_phase(dev, reset_counts, counts, smi))
        print(smi)
        print("chip_smoke --only-parallel: phases 2-25 not run; no result")
        return 0

    def camera(scene, W, H, pixel_ids, sample_ids):
        return init_state(make_basis(scene.camera, W, H), W, H, pixel_ids,
                          sample_ids, 0)

    def lanes(W, H, spp):
        pix = torch.arange(W * H, dtype=torch.int64, device=dev)
        return pix.repeat(spp), torch.arange(
            spp, dtype=torch.int64, device=dev).repeat_interleave(W * H)

    # Phase 2: K1 against its plain version on the card.
    cases = []
    W, H = 1280, 720
    pix = torch.arange(W * H, dtype=torch.int64, device=dev)
    for name in ("random", "three-spheres"):
        scene = build_scene(name)
        st = to_device(scene.arrays, scene.static, dev)
        cam = camera(scene, W, H, pix, torch.zeros_like(pix))
        cases.append((f"{name} camera 1280x720", st, cam.o, cam.d, cam.time,
                      cam.alive))
        sec = bounce_step(st, scene.background, cam, 0)
        cases.append((f"{name} secondary 1280x720", st, sec.o, sec.d,
                      sec.time, sec.alive))
        if name == "random":
            random_t, random_cam = st, cam
    half = torch.arange(W * H, device=dev) % 2 == 0
    cases.append(("random camera, half inactive", random_t, cases[0][2],
                  cases[0][3], cases[0][4], half))
    n_odd = 1_000_003
    ids = torch.arange(n_odd, dtype=torch.int64, device=dev)
    odd = camera(build_scene("random"), W, H, ids % (W * H), ids // (W * H))
    cases.append((f"random camera N={n_odd}", random_t, odd.o, odd.d,
                  odd.time, odd.alive))
    k1_err, agreements = 0.0, []
    for label, st, o, d, tm, active in cases:
        args = (*st.spheres, o.contiguous(), d.contiguous(),
                tm.contiguous(), active.contiguous(), T_MIN)
        t_k, b_k = sphere_sweep(*args)
        torch.cuda.synchronize()
        t_p, b_p = sphere_sweep_plain(*args)
        agree, exact, err = sweep_rules(f"K1 {label}", t_k, b_k, t_p, b_p,
                                        active)
        agreements.append(f"{label}: {agree:.6f} (bit-equal {exact:.6f})")
        k1_err = max(k1_err, err)
    k1_args = (*random_t.spheres, cases[0][2], cases[0][3], cases[0][4],
               cases[0][5], T_MIN)
    k1_ms, k1_plain_ms = in_turns(sphere_sweep_plain, sphere_sweep, k1_args,
                                  3, 20)
    n_k1, p_k1 = W * H, random_t.spheres.p0.shape[0]
    moving = int((random_t.spheres.p1 != random_t.spheres.p0).any(1).sum())
    # Rays: o, d, time, active read (29 B), t and index written (8 B).
    k1_ops = sweep_fp_ops(random_t.sweep, kinds)
    k1_bound = bound(n_k1 * 37, n_k1 * k1_ops)
    # A static sphere's pair in the loop of the kernel for scenes with no
    # motion; the motion kernel's loop is unswitched on the record's
    # shutter slot, so its SASS holds a lerping and a static copy.
    k1_sass_lib = sass_of("sphere_sweep")
    k1_sass = sass_pair_ops(k1_sass_lib,
                            f"sphere_sweep_kernelILi{packet}ELb0E", packet)
    k1_sass_mo = sass_pair_ops(k1_sass_lib,
                               f"sphere_sweep_kernelILi{packet}ELb1E", packet)
    k1_mo_all = k1_sass_mo["all"] + k1_sass_mo["branch"]
    phase(2, f"sphere_sweep (R={packet}) vs plain, bit-equal on every case: "
          f"winner agreement "
          f"[{'; '.join(agreements)}], max |dt| on matched hits "
          f"{k1_err:.3e}; at N={n_k1} P={p_k1} ({moving} moving) kernel "
          f"{k1_ms:.4f} ms, plain {k1_plain_ms:.4f} ms, bound "
          f"{k1_bound[0]:.4f} ms ({k1_bound[1]}, {k1_ops} FP32 operations "
          f"per ray), {k1_bound[0] / k1_ms:.3f} of it; SASS per pair "
          f"(R={packet}): a static sphere "
          f"{k1_sass['fp32']:.2f} FP32 operations, {k1_sass['int']:.2f} "
          f"integer, {k1_sass['all']:.2f} instructions issued every pair, "
          f"{k1_sass['branch']:.2f} more on branches (the roots); the "
          f"motion kernel's loop {k1_mo_all:.2f} in all (both copies of "
          f"its body); contract "
          f"{SWEEP_PAIR_OPS['sphere']} (+{SWEEP_MOTION_OPS} moving); ptxas: "
          f"{resources(ptxas['sphere_sweep'])}")

    # Phase 3: the `random` golden rendered on the card through K1.
    reset_counts()
    golden = np.load(ROOT / "tests" / "golden" /
                     "random_160x90_2spp_d8.npy")
    img = render_image(build_scene("random"),
                       RenderSettings(160, 90, 2, 8), dev)
    torch.cuda.synchronize()
    launched = counts()
    assert launched["sphere_sweep"] > 0, "the golden render missed K1"
    med, mean, outl = golden_errors(img, golden)
    phase(3, f"random 160x90 2spp d8 on {kind}: median err {med:.3e}, "
          f"mean err {mean:.3e}, outliers {outl:.4f} "
          f"(bounds 1e-3 / 4e-3 / 0.02); launches {launched}")

    # Phase 4: the CLI's default workload (random, 1280x720, 100 spp,
    # depth 10) through the entry point a user calls.
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "random.png"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.monotonic()
        rc = cli_main(["--output", str(out)])
        wall = time.monotonic() - t0
        random_launches = counts()
        assert rc == 0, f"CLI exit code {rc}"
        assert random_launches["sphere_sweep"] > 0, \
            "the main path never launched sphere_sweep"
        png = read_png(out)
        random_png = png
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    assert png.shape == (720, 1280, 3), png.shape
    lum = png.astype(np.float64).mean()
    assert 60 < lum < 250, f"PNG mean {lum}"
    # The flat sky (0.7, 0.8, 1.0) fills the top rows: bluer than red.
    top = png[:36].astype(np.float64)
    assert top[..., 2].mean() > top[..., 0].mean() + 10, "no sky at the top"
    assert len(np.unique(png.reshape(-1, 3), axis=0)) > 1000, \
        "the image is flat"
    rays = 1280 * 720 * 100
    phase(4, f"CLI default render random 1280x720 100spp d10: wall "
          f"{wall:.3f} s, {rays / wall / 1e6:.3f} camera Mrays/s, "
          f"launches {random_launches}, peak device memory "
          f"{peak_gb:.2f} GB, PNG mean {lum:.1f}")

    # Phase 5: K1b against its plain version on the card.
    BW, BH, BSPP = 400, 225, 16  # bench.py's workload
    final = build_scene("final")
    final_t = to_device(final.arrays, final.static, dev)
    final_cam = camera(final, BW, BH, *lanes(BW, BH, BSPP))
    sweeps = []  # (label, scene tensors, state, bounce, active)
    sweeps.append((f"final camera {BW}x{BH}x{BSPP}", final_t, final_cam, 0,
                   final_cam.alive))
    final_sec = bounce_step(final_t, final.background, final_cam, 0)
    sweeps.append(("final first bounce", final_t, final_sec, 1,
                   final_sec.alive))
    for name in ("cornell", "cornell-smoke"):
        scene = build_scene(name)
        st = to_device(scene.arrays, scene.static, dev)
        cam = camera(scene, BW, BH, *lanes(BW, BH, 2))
        sweeps.append((f"{name} camera {BW}x{BH}x2", st, cam, 0, cam.alive))
        sec = bounce_step(st, scene.background, cam, 0)
        sweeps.append((f"{name} first bounce", st, sec, 1, sec.alive))
    n_final = BW * BH * BSPP
    sweeps.append(("final camera, half inactive", final_t, final_cam, 0,
                   torch.arange(n_final, device=dev) % 2 == 0))
    odd_ids = torch.arange(n_odd, dtype=torch.int64, device=dev)
    final_odd = camera(final, BW, BH, odd_ids % (BW * BH),
                       odd_ids // (BW * BH))
    sweeps.append((f"final camera N={n_odd}", final_t, final_odd, 0,
                   final_odd.alive))

    def typed_args(st, s, bounce, active):
        return (st.sweep, s.o.contiguous(), s.d.contiguous(),
                s.time.contiguous(), active.contiguous(),
                prng.bounce_base(s.base, bounce).contiguous(), T_MIN)

    k1b_err, lines = 0.0, []
    for label, st, s, bounce, active in sweeps:
        args = typed_args(st, s, bounce, active)
        t_k, b_k = typed_sweep(*args)
        torch.cuda.synchronize()
        t_p, b_p = typed_sweep_plain(*args)
        agree, exact, err = sweep_rules(f"K1b {label}", t_k, b_k, t_p, b_p,
                                        active)
        lines.append(f"{label}: {agree:.6f} (bit-equal {exact:.6f})")
        k1b_err = max(k1b_err, err)
    k1b_args = typed_args(final_t, final_cam, 0, final_cam.alive)
    k1b_ms, k1b_plain_ms = in_turns(typed_sweep_plain, typed_sweep,
                                    k1b_args, 3, 20)
    probe_sass = sass_of(PROBES)
    k1b_sass = {
        label: sass_pair_ops(
            probe_sass, f"fold_probeILi{packet}ELi{pt}ELb{xf}ELb{mo}E",
            1 if xf else packet)
        for label, pt, xf, mo in PROBE_KINDS}

    # Rays: o, d, time, active, bits read (37 B), t and index written.
    k1b_ops = sweep_fp_ops(final_t.sweep, kinds)
    k1b_bound_main = bound(n_final * 45, n_final * k1b_ops)
    # K1b on `random`'s camera rays beside K1 (same shape as phase 2).
    rnd_args = typed_args(random_t, random_cam, 0, random_cam.alive)
    t_k, b_k = typed_sweep(*rnd_args)
    t_p, b_p = sphere_sweep(*k1_args)
    same = (torch.equal(t_k, t_p) and torch.equal(b_k, b_p))
    assert same, "K1b and K1 differ on random's camera rays"
    k1_turn = time_ms(sphere_sweep, k1_args, 20)
    k1b_turn = time_ms(typed_sweep, rnd_args, 20)
    k1b_turn2 = time_ms(typed_sweep, rnd_args, 20)
    k1_turn2 = time_ms(sphere_sweep, k1_args, 20)
    phase(5, f"typed_sweep (R={packet}) vs plain, bit-equal on every case: "
          f"winner agreement [{'; '.join(lines)}],"
          f" max |dt| on matched hits {k1b_err:.3e}; at N={n_final} "
          f"P={final.static.n_prims} ({len(final_t.sweep.plan)} plan tiles) "
          f"kernel {k1b_ms:.4f} ms, plain {k1b_plain_ms:.4f} ms, bound "
          f"{k1b_bound_main[0]:.4f} ms ({k1b_bound_main[1]}, {k1b_ops} FP32 "
          f"operations per ray), {k1b_bound_main[0] / k1b_ms:.3f} of it; "
          f"on random's camera rays (N={n_k1}) K1b "
          f"{(k1b_turn + k1b_turn2) / 2:.4f} ms vs K1 "
          f"{(k1_turn + k1_turn2) / 2:.4f} ms, the same hits as K1 "
          f"(asserted); SASS per pair by tile kind (R={packet}; FP32 "
          "operations / integer / issued every pair / more on branches): "
          + "; ".join(f"{k} {v['fp32']:.2f} / {v['int']:.2f} / "
                      f"{v['all']:.2f} / {v['branch']:.2f}"
                      for k, v in k1b_sass.items())
          + f"; contract per pair {SWEEP_PAIR_OPS} (+{SWEEP_MOTION_OPS} "
          f"moving, +{SWEEP_XFORM_OPS} transformed); ptxas: "
          f"{resources(ptxas['typed_sweep'])} (+ a dynamic ring of 16 KB, "
          f"40 KB with transformed tiles); the tile kinds' folds alone: "
          + "; ".join(
              f"{label} {ptxas[PROBES][probe][0]} registers"
              for label, probe in (
                  (label, f"fold_probe<{packet},{pt},{xf},{mo}>")
                  for label, pt, xf, mo in PROBE_KINDS)))

    # Phase 6: K2, the noise branch of texture_value, against its plain
    # version at the bench shape, on the inputs of `final`'s first bounce:
    # its real noise mask, every lane noise, every other lane noise.
    bb0 = prng.bounce_base(final_cam.base, 0)
    t_hit, prim = trace(final_t, final_cam, bb0)
    pidx = torch.clamp(prim, min=0).long()
    pf, sf = gather_prim_shade_packed(final_t.fpack, final_t.ipack, pidx,
                                      final.static)
    det = hit_detail(pf, final_cam.o, final_cam.d, final_cam.time,
                     torch.where(prim >= 0, t_hit, 1.0), final.static)
    gi = final_t.ipack[pidx]  # the texture type is column 5, stride 7
    even = torch.arange(n_final, device=dev) % 2 == 0
    k2 = {}
    for label, col in (("real mask", gi[:, 5]),
                       ("all-true", torch.full_like(gi[:, 5], TT_NOISE)),
                       ("half", torch.where(even, TT_NOISE, TT_SOLID))):
        rows = gi.clone()
        rows[:, 5] = col
        args = (rows[:, 5], sf.scale, det.point, sf.color1, final_t.tables)
        got = noise_texture(*args)
        torch.cuda.synchronize()
        ref = noise_texture_plain(*args)
        assert torch.equal(got, ref), f"noise_texture not bit-equal ({label})"
        ms, plain_ms = in_turns(noise_texture_plain, noise_texture, args, 3,
                                20)
        dev_ms = device_ms(noise_texture, args, 20)
        n_noise = int((rows[:, 5] == TT_NOISE).sum())
        # Bytes: every lane's texture type (4), a noise lane's scale, point
        # and marble (28), any other lane's value read and written (24).
        # K2's own work is the marble's: the flags and the noise lanes.
        work_bytes = n_final * 4 + n_noise * 28
        k2[label] = dict(
            n=n_noise, err=(got - ref).abs().max().item(), ms=dev_ms,
            call_ms=ms, plain_ms=plain_ms,
            bound=bound(work_bytes + (n_final - n_noise) * 24,
                        n_noise * TURB_OPS),
            work=bound(work_bytes, n_noise * TURB_OPS))

    def eager_around_k2(ttype, scale, point, value, m):
        """The eager noise branch this kernel replaced, less the marble:
        the compare, the scale multiply, three column copies, the
        where."""
        is_noise = ttype == TT_NOISE
        sp = scale[..., None] * point
        xyz = [sp[..., c].contiguous() for c in range(3)]
        return xyz, torch.where(is_noise[..., None],
                                m[..., None].expand_as(value), value)

    args = (gi[:, 5], sf.scale, det.point, sf.color1,
            noise_texture(gi[:, 5], sf.scale, det.point, sf.color1,
                          final_t.tables)[:, 0].contiguous())
    eager_ms = (time_ms(eager_around_k2, args, 20)
                + time_ms(eager_around_k2, args, 20)) / 2
    eager_dev_ms = device_ms(eager_around_k2, args, 20)
    # What the strided views cost alone: torch's copies of the value
    # column, of the whole gathered float rows it lies in, and of the
    # texture-type column.
    g = final_t.fpack[pidx]
    copies_ms = [device_ms(torch.clone, (x,), 20)
                 for x in (sf.color1, g, gi[:, 5])]
    turb_sass = sass_of("turbulence")
    # K2 without its save (the instantiation every render runs).
    k2_sass = {k: v * TURB_OCTAVES for k, v in sass_pair_ops(
        turb_sass, "noise_texture_kernelILb0E", 1).items()}
    phase(6, f"noise_texture vs plain at N={n_final}, bit-equal on every "
          f"mask (asserted): " + "; ".join(
              f"{label} ({v['n']} noise lanes): kernel {v['ms']:.4f} ms on "
              f"the device ({v['call_ms']:.4f} ms a call back to back), "
              f"plain {v['plain_ms']:.4f} ms, bound {v['bound'][0]:.6f} ms "
              f"({v['bound'][1]}), {v['bound'][0] / v['ms']:.3f} of it; "
              f"K2's own work {v['work'][0]:.6f} ms ({v['work'][1]})"
              for label, v in k2.items())
          + "; the replaced eager operations around the marble (real "
          f"mask) {eager_dev_ms:.4f} ms on the device ({eager_ms:.4f} ms a "
          f"call); torch's copy of the value column {copies_ms[0]:.4f} ms, "
          f"of the gathered float rows ([N, {g.shape[1]}]) "
          f"{copies_ms[1]:.4f} ms, of the texture-type column "
          f"{copies_ms[2]:.4f} ms; contract {TURB_OPS} FP32 operations per "
          f"noise lane; SASS per noise lane ({TURB_OCTAVES} octave-loop "
          f"trips): {k2_sass['fp32']:.0f} FP32 operations, "
          f"{k2_sass['int']:.0f} integer, {k2_sass['all']:.0f} issued, "
          f"{k2_sass['branch']:.0f} more on branches; ptxas: "
          f"{resources(ptxas['turbulence'])}")

    # Phase 7: the goldens of the scenes K1b and K6 open, on the card.
    glines = []
    saves = counter("K2.saves")
    for name, spp, depth in (("final", 1, 5), ("cornell", 4, 8),
                             ("cornell-smoke", 4, 8), ("simple-light", 4, 8),
                             ("earth", 4, 8), ("two-perlin-spheres", 4, 8)):
        scene = build_scene(name)
        st = to_device(scene.arrays, scene.static, dev)
        golden = np.load(ROOT / "tests" / "golden" /
                         f"{name}_160x90_{spp}spp_d{depth}.npy")
        reset_counts()
        img = render_image(scene, RenderSettings(160, 90, spp, depth), dev)
        torch.cuda.synchronize()
        launched = counts()
        uses = {"sphere_sweep": st.sphere_only,
                "typed_sweep": not st.sphere_only,
                "turbulence": False, "turbulence_bwd": False,
                "segment_sum": False, "bvh_traverse": False,
                "shade": True}
        for kname, used in uses.items():
            assert (launched[kname] > 0) == used, (name, kname, launched)
        med, mean, outl = golden_errors(img, golden)
        glines.append(f"{name} {spp}spp d{depth}: median {med:.3e} mean "
                      f"{mean:.3e} outliers {outl:.4f}, launches "
                      f"{ {k: v for k, v in launched.items() if v} }")
    assert counter("K2.saves") == saves, "a render without grad saved"
    phase(7, f"goldens on {kind} (bounds 1e-3 / 4e-3 / 0.02): "
          + "; ".join(glines) + "; K2 saved nothing for a backward "
          "(asserted)")

    # Phase 8: where the device time of a render goes, on the path users
    # run (render_profile).  The bench render (final 400x225x16, depth
    # 10: one chunk) and one chunk of the CLI default (random 1280x720, 9
    # spp, depth 10).
    phase(8, "device time of the real render path: "
          + " | ".join((render_profile(dev, "final",
                                       RenderSettings(BW, BH, BSPP, 10)),
                        render_profile(dev, "random",
                                       RenderSettings(1280, 720, 9, 10)))))

    # Phase 9: the bench workload (final, 400x225, 16 spp, depth 10)
    # through the CLI.
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "final.png"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.monotonic()
        rc = cli_main(["--scene", "final", "--width", str(BW), "--height",
                       str(BH), "--samples", str(BSPP), "--depth", "10",
                       "--output", str(out)])
        wall = time.monotonic() - t0
        final_launches = counts()
        assert rc == 0, f"CLI exit code {rc}"
        assert final_launches["typed_sweep"] > 0, "the bench path missed K1b"
        assert final_launches["shade"] > 0, "the bench path missed K6"
        png = read_png(out)
        final_sweep_png = png
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    assert png.shape == (BH, BW, 3), png.shape
    lum = png.astype(np.float64).mean()
    assert len(np.unique(png.reshape(-1, 3), axis=0)) > 200, \
        "the image is flat"
    # The ceiling light (y = 554, x 123..423, z 147..412) seen from the
    # camera: its patch is brighter than the image's mean.
    basis = make_basis(final.camera, BW, BH)
    corners = [project(basis, (x, 554.0, z), BW, BH)
               for x in (123.0, 423.0) for z in (147.0, 412.0)]
    cols = [c for c, _ in corners]
    rows = [r for _, r in corners]
    c0, c1 = int(np.ceil(min(cols))), int(np.floor(max(cols)))
    r0, r1 = int(np.ceil(min(rows))), int(np.floor(max(rows)))
    c0, r0 = max(c0, 0), max(r0, 0)
    patch = png[r0:r1 + 1, c0:c1 + 1].astype(np.float64)
    assert patch.size, (r0, r1, c0, c1)
    assert patch.mean() > lum + 20, f"light patch {patch.mean()} vs {lum}"
    rays = BW * BH * BSPP
    phase(9, f"CLI bench render final {BW}x{BH} {BSPP}spp d10: wall "
          f"{wall:.3f} s, {rays / wall / 1e6:.3f} camera Mrays/s, "
          f"launches {final_launches}, peak device memory {peak_gb:.2f} GB, "
          f"PNG mean {lum:.1f}, light patch rows {r0}-{r1} cols {c0}-{c1} "
          f"mean {patch.mean():.1f}")

    # Phase 10: K2b against its plain version on phase 6's inputs.
    k2b = k2b_phase(dev, gi, sf, det, final_t.tables)
    k2b_sass = sass_pair_ops(turb_sass, "noise_texture_grad_kernel", 1)
    phase(10, k2b_line(k2b, n_final, resources(ptxas["turbulence"]),
                       k2b_sass))

    # Phase 11: a train step's gradients on the card against the CPU's.
    phase(11, "card gradients vs the CPU's at 64x36 2spp d4 (asserted): "
          + "; ".join(card_grad_check(build_scene(name), dev, share)
                      for name, share in CARD_GRAD_SHARE.items()))

    # Phases 12-13: the train step at bench_grad.py's workload, partitioned
    # as bench_grad.py's descent and the train CLI are by default, the
    # counts set to 0 just before its timed steps and read just after.
    random_train = train_run(build_scene("random"), dev, TRAIN_SHAPE, 3,
                             reset_counts, counts, partition=True)
    for kname in ("sphere_sweep", "segment_sum"):
        assert random_train["launched"][kname] > 0, \
            f"the random train step missed {kname}"
    assert random_train["gmax"]["materials.albedo"] > 0
    # `random` lights every path with a flat sky through solid or checker
    # textures, so its geometry gradients are exactly 0, in the JAX
    # package too; `final` below carries them.
    phase(12, "train step " + train_line("random", TRAIN_SHAPE,
                                         random_train))
    final_train = train_run(final, dev, TRAIN_SHAPE, 3, reset_counts,
                            counts, partition=True)
    for kname in ("typed_sweep", "turbulence", "turbulence_bwd",
                  "segment_sum"):
        assert final_train["launched"][kname] > 0, \
            f"the final train step missed {kname}"
    for k in ("geom.p0", "textures.scale", "materials.albedo"):
        assert final_train["gmax"][k] > 0, f"final: {k}'s gradient is 0"
    phase(13, "train step " + train_line("final", TRAIN_SHAPE, final_train))

    # Phase 14: `random` at depth 50 through the train CLI.
    phase(14, deep_train_line(TRAIN_SHAPE[:3], 50))

    # Phase 15: K3 against its plain version and index_add_ at the
    # gathers of the train steps above (their first bounce), and against
    # the parent design when one is given.
    TW, TH, TSPP = TRAIN_SHAPE[:3]
    k3 = k3_phase(dev, k3_cases(dev, (TW, TH, TSPP)),
                  parent_k3(dev, parent) if parent else None)
    phase(15, k3_line(k3, resources(ptxas["segment_sum"])))

    # Phase 16: two train steps from one state, bit-equal gradients.
    phase(16, f"train steps at {TW}x{TH}x{TSPP} d{TRAIN_SHAPE[3]} twice "
          "from one restored state: " + "; ".join(
              determinism_line(build_scene(name), dev, TRAIN_SHAPE)
              for name in ("random", "final", "earth")))

    # Phase 17: what K3 costs a train step against index_add_, in turns.
    phase(17, "train step with the gathers' backward through K3 vs "
          "index_add_ (gather_rows swapped for index_select), in turns "
          "K3, index_add_, index_add_, K3, each turn the best of 5 "
          "steps from one restored state: " + "; ".join(
              k3_cost_line(name, k3_step_cost(build_scene(name), dev,
                                              TRAIN_SHAPE))
              for name in ("random", "final")))

    # Phase 18: K4 against its plain version, and the sweeps beside it.
    k4_lines, k4, k4_err = k4_phase(dev, kinds)
    k4_rows, k4_spp, k4_chunk_err = k4_chunk(dev, kinds)
    k4_err = max(k4_err, k4_chunk_err)
    phase(18, k4_line(k4_lines, k4, resources(ptxas["bvh_traverse"]))
          + " | " + k4_chunk_line(k4_rows, k4_spp))

    # Phase 19: BVH mode end to end.  The CLI at its defaults on
    # `sphereflake` (1280x720, 100 spp, depth 10) with --intersector bvh.
    flake_rays = 1280 * 720 * 100
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "sphereflake.png"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.monotonic()
        rc = cli_main(["--scene", "sphereflake", "--intersector", "bvh",
                       "--output", str(out)])
        flake_wall = time.monotonic() - t0
        flake_launches = counts()
        assert rc == 0, f"CLI exit code {rc}"
        assert flake_launches["bvh_traverse"] > 0, \
            "the BVH path never launched bvh_traverse"
        assert flake_launches["sphere_sweep"] == 0, flake_launches
        png = read_png(out)
        flake_bvh_png = png
    flake_peak = torch.cuda.max_memory_allocated() / 1e9
    assert png.shape == (720, 1280, 3), png.shape
    assert len(np.unique(png.reshape(-1, 3), axis=0)) > 1000, \
        "the image is flat"
    flake_lum = png.astype(np.float64).mean()
    flake = build_scene("sphereflake")
    t0 = time.monotonic()
    flake_arrays, flake_tree, _ = prepare_scene(flake, "bvh")
    flake_prep = time.monotonic() - t0
    t0 = time.monotonic()
    build_bvh(flake.arrays.geom, 4, use_native=False)
    flake_numpy_build = time.monotonic() - t0
    t0 = time.monotonic()
    to_device(flake_arrays, flake.static, dev, flake_tree)
    torch.cuda.synchronize()
    flake_upload = time.monotonic() - t0
    # The CLI default's render by layer, as phase 8's; K4 by bounce.
    reset_counts()
    flake_profile = render_profile(dev, "sphereflake", RenderSettings(
        1280, 720, 100, 10, intersector="bvh"))
    flake_profile_k4 = counts()["bvh_traverse"]
    # `sphereflake` through the sweep and through the BVH at one reduced
    # shape, through the CLI, and the two PNGs held to the goldens' bounds.
    RW, RH, RSPP = 640, 360, 4
    walls, pngs = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for mode in ("sweep", "bvh"):
            out = Path(tmp) / f"{mode}.png"
            torch.cuda.synchronize()
            t0 = time.monotonic()
            rc = cli_main(["--scene", "sphereflake", "--intersector", mode,
                           "--width", str(RW), "--height", str(RH),
                           "--samples", str(RSPP), "--output", str(out)])
            walls[mode] = time.monotonic() - t0
            assert rc == 0, f"CLI exit code {rc}"
            pngs[mode] = read_png(out).astype(np.float64) / 255.0
    same_px = (pngs["bvh"] == pngs["sweep"]).all(-1).mean()
    png_err = golden_errors(pngs["bvh"], pngs["sweep"])
    # sphereflake-small's golden through the BVH.
    golden = np.load(ROOT / "tests" / "golden" /
                     "sphereflake-small_160x90_4spp_d8.npy")
    reset_counts()
    img = render_image(build_scene("sphereflake-small"),
                       RenderSettings(160, 90, 4, 8, intersector="bvh"), dev)
    assert counts()["bvh_traverse"] > 0, "the golden render missed K4"
    small_err = golden_errors(img, golden)
    # random and cornell through the BVH and through the sweeps: equal.
    equal = []
    for name in ("random", "cornell"):
        scene = build_scene(name)
        imgs = [render_image(scene, RenderSettings(160, 90, 2, 8,
                                                   intersector=mode), dev)
                for mode in ("bvh", "sweep")]
        assert np.array_equal(*imgs), f"{name}: BVH and sweep images differ"
        equal.append(name)
    # Under auto the reference scenes still trace through the sweeps.
    auto = {}
    for name, kernel in (("random", "sphere_sweep"), ("final", "typed_sweep")):
        reset_counts()
        render_image(build_scene(name), RenderSettings(64, 36, 1, 3), dev)
        auto[name] = counts()
        assert auto[name][kernel] > 0 and auto[name]["bvh_traverse"] == 0, \
            (name, auto[name])
    phase(19, f"CLI sphereflake --intersector bvh 1280x720 100spp d10 "
          f"({flake_rays} camera rays): wall {flake_wall:.3f} s, "
          f"{flake_rays / flake_wall / 1e6:.3f} camera Mrays/s, launches "
          f"{flake_launches}, peak device memory {flake_peak:.2f} GB, PNG "
          f"mean {flake_lum:.1f}; its BVH's host build (prepare_scene, the "
          f"native builder) {flake_prep:.3f} s (the NumPy builder "
          f"{flake_numpy_build:.3f} s), its upload (to_device) "
          f"{flake_upload:.3f} s"
          f" | by layer: {flake_profile} (K4 launches over the three "
          f"renders {flake_profile_k4}) | sphereflake {RW}x{RH} {RSPP}spp d10 "
          f"through the CLI: --intersector sweep {walls['sweep']:.3f} s, "
          f"bvh {walls['bvh']:.3f} s ({walls['sweep'] / walls['bvh']:.2f}x);"
          f" PNGs: {same_px:.6f} of pixels equal, median / mean err / "
          f"outliers {png_err[0]:.3e} / {png_err[1]:.3e} / {png_err[2]:.4f} "
          "(golden bounds, asserted) | sphereflake-small 160x90 4spp d8 "
          f"through the BVH vs its golden: median {small_err[0]:.3e} mean "
          f"{small_err[1]:.3e} outliers {small_err[2]:.4f} (asserted) | "
          f"BVH images equal to the sweeps' at 160x90 2spp d8 (asserted): "
          f"{', '.join(equal)} | under auto (asserted: the sweeps, not K4): "
          + "; ".join(f"{k} {v}" for k, v in auto.items()))

    # Phases 20-21: training through the BVH, and with the silhouette.
    flake_train = train_phases(dev, reset_counts, counts, flake,
                               random_train)

    # Phase 22: checkpoint/resume, preview, watch and profile through the
    # CLI at its default workload.
    phase(22, "operations: " + ops_phase(reset_counts, counts))

    # Phase 23: the four fits at their own defaults.
    phase(23, "fits: " + fits_phase(reset_counts, counts))

    # Phase 24: cluster mode (K5) end to end.
    k5_text, k5_record = cluster_phase(
        dev, kinds, reset_counts, counts, flake_bvh_png, final_sweep_png,
        resources(ptxas["cluster_sweep"]))
    phase(24, k5_text)

    # Phase 25: the partitioned sweep (K1b's and K1's masked forms, the
    # CLIs with and without --no-partition).
    part_text, part_record = partition_phase(
        dev, kinds, reset_counts, counts, final_sweep_png, random_png)
    phase(25, part_text)

    # Phase 26: multi-GPU rendering and training through torch.distributed.
    phase(26, parallel_phase(dev, reset_counts, counts, smi))

    # Phase 27: K1b's bf16 form (RenderSettings.bf16_hits); the F6
    # repair's pin.
    bf16_text, bf16_record = bf16_phase(dev, kinds, reset_counts, counts,
                                        sass_of(PROBES), bf16_shape,
                                        ptxas=bf16_ptxas)
    phase(27, bf16_text + " | F6: " + f6_pin(dev))

    # Phase 28: K6 against the eager shading at the main path's shape.
    k6_text, k6_record = k6_phase(dev, resources(ptxas["shade"]))
    phase(28, k6_text)

    kernels = [
        {"name": "sphere_sweep", "route": "cuda",
         "source": "hyper_ray_tracer_tpu_torch/csrc/sphere_sweep.cu",
         "replaces": "hyper_ray_tracer_tpu/ops/pallas_sweep.py:38",
         "launches": random_launches["sphere_sweep"],
         "max_abs_err": k1_err, "ms": k1_ms, "plain_ms": k1_plain_ms,
         "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
         "library_ms": None, **part_record["sphere_sweep"]},
        {"name": "typed_sweep", "route": "cuda",
         "source": "hyper_ray_tracer_tpu_torch/csrc/typed_sweep.cu",
         "replaces": "hyper_ray_tracer_tpu/ops/bvh.py:273",
         "launches": final_launches["typed_sweep"],
         "max_abs_err": k1b_err, "ms": k1b_ms, "plain_ms": k1b_plain_ms,
         "bound_ms": k1b_bound_main[0], "bound_by": k1b_bound_main[1],
         "library_ms": None, **part_record["typed_sweep"]},
        {"name": "turbulence", "route": "cuda",
         "source": "hyper_ray_tracer_tpu_torch/csrc/turbulence.cu",
         "replaces": "tools/prof_tex.py:69",
         "launches": final_train["launched"]["turbulence"],
         "max_abs_err": max(v["err"] for v in k2.values()),
         "ms": k2["real mask"]["ms"], "plain_ms": k2["real mask"]["plain_ms"],
         "bound_ms": k2["real mask"]["bound"][0],
         "bound_by": k2["real mask"]["bound"][1], "library_ms": None},
        {"name": "turbulence_bwd", "route": "cuda",
         "source": "hyper_ray_tracer_tpu_torch/csrc/turbulence.cu",
         "replaces": "hyper_ray_tracer_tpu/ops/perlin.py:203",
         "launches": final_train["launched"]["turbulence_bwd"],
         "max_abs_err": max(e[0] for v in k2b.values()
                            for e in v["errs"].values()),
         "ms": k2b["real mask"]["ms"],
         "plain_ms": k2b["real mask"]["plain_ms"],
         "bound_ms": k2b["real mask"]["bound"][0],
         "bound_by": k2b["real mask"]["bound"][1], "library_ms": None,
         # the same work by the first design's contract (type column,
         # the octaves' values again)
         "old_bound_ms": k2b["real mask"]["old_bound"][0],
         "old_bound_by": k2b["real mask"]["old_bound"][1]},
        {"name": "segment_sum", "route": "cuda",
         "source": "hyper_ray_tracer_tpu_torch/csrc/segment_sum.cu",
         "replaces": "hyper_ray_tracer_tpu/ops/intersect.py:234",
         "launches": final_train["launched"]["segment_sum"],
         "max_abs_err": 0.0, "ms": k3["random"]["ms"],
         "plain_ms": k3["random"]["plain_ms"],
         "bound_ms": k3["random"]["bound"][0],
         "bound_by": k3["random"]["bound"][1],
         "library_ms": k3["random"]["library_ms"],
         # the parent design on the same inputs, in turns (--parent)
         "parent_ms": k3["random"].get("parent_ms")},
        {"name": "bvh_traverse", "route": "cuda",
         "source": "hyper_ray_tracer_tpu_torch/csrc/bvh_traverse.cu",
         "replaces": "hyper_ray_tracer_tpu/ops/bvh.py:408",
         "launches": flake_launches["bvh_traverse"],
         "max_abs_err": k4_err, "ms": k4["sphereflake"]["ms"],
         "plain_ms": k4["sphereflake"]["plain_ms"],
         "bound_ms": k4["sphereflake"]["bound"][0],
         "bound_by": k4["sphereflake"]["bound"][1], "library_ms": None,
         # the first design's walk on the same rays (bvh_traverse_dfs_plain)
         "old_bound_ms": k4["sphereflake"]["dfs_bound"][0],
         "old_bound_by": k4["sphereflake"]["dfs_bound"][1]},
        k5_record,
        {"name": "typed_sweep_bf16", "route": "cuda",
         "source": "hyper_ray_tracer_tpu_torch/csrc/typed_sweep.cu",
         "replaces": "hyper_ray_tracer_tpu/ops/bvh.py:74",
         "launches": bf16_record["launches"],
         "max_abs_err": bf16_record["max_abs_err"],
         "ms": bf16_record["ms"], "plain_ms": bf16_record["plain_ms"],
         "bound_ms": bf16_record["bound_ms"],
         "bound_by": bf16_record["bound_by"], "library_ms": None},
        {"name": "shade", "route": "cuda",
         "source": "hyper_ray_tracer_tpu_torch/csrc/shade.cu",
         "replaces": "hyper_ray_tracer_tpu_torch/render.py shade_hits "
                     "(its eager operations; no TPU kernel)",
         "launches": final_launches["shade"], "max_abs_err": 0.0,
         **k6_record, "library_ms": None},
    ]
    print(nvidia_smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
