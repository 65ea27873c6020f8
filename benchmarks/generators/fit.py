"""Fit traffic: a closed loop of adam steps of ``train.make_train_step``.

Traffic parameters (``traffic/<name>.json``): ``width``, ``height``,
``spp``, ``depth``, ``intersector``, ``leaf_size``, ``partition``,
``remat``, ``silhouette``, ``learning_rate``, ``perturb``,
``perturb_leaves``, ``seed_stride``, ``check_steps``, ``check_share``.

Inputs, all from ``--seed``: the starting parameters are the scene's
trainable leaves as the reference's own builders make them
(``reference/builders.py``), each element of the ``perturb_leaves``
multiplied by (1 + perturb * a normal draw).  The geometry is left as
built: a moved ground or group box changes the work a step does (the
partition's decisions), and every seed has to do the same work.  The
target is each pixel's mean radiance of the unperturbed scene (RNG seed
``k = 0`` below).  Step k (k = 1, 2, ...) renders its lanes with the RNG
seed ``(seed * seed_stride + k) mod 2**32``, so that no two steps draw
the same samples, and the parameters evolve from step to step: nothing
is restored.

Set-up builds one train step and its state, and drives it through its
first ``check_steps`` steps with the window's own call; the window goes
on with that same state.  One step of the window, drawn from the seed
among its first ``check_share`` of the steps the window is expected to
hold (by the set-up steps' walls; the window runs on until it has run),
is bracketed by copies of the parameters and of adam's moments and step
count, taken to the host.

The check, once the window has closed, follows with the reference
(``reference/``), from its own render of the target:

* the set-up's steps from the same start: each step's loss, the first
  gradient as adam got it (its first moment after one step, over
  1 - beta1), and the parameters' change over the steps;
* the window's step from the program's own state before it (the copies):
  its loss, its gradient as adam got it ((m_after - beta1 m_before) /
  (1 - beta1)), and adam's update (the parameters after less before)
  against the reference's adam from the same moments and step count;

each gradient and change by the worst leaf's norm against the
reference's.  The leaves the program reads at the start are also held
to the reference's own build of the scene (``failed`` where they part).
"""

from __future__ import annotations

import statistics
import sys
import time

import numpy as np
import torch

from benchmarks import faults
from benchmarks.generators.render import device_info
from benchmarks.reference.builders import build_scene as reference_scene
from benchmarks.reference.tracer import for_scene, scene_leaves
from benchmarks.trace import capture, merge, summarize

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def step_seed(seed: int, stride: int, k: int) -> int:
    return (seed * stride + k) & 0xFFFFFFFF


def _rng(seed: int, salt: int):
    s = seed % (1 << 64)
    return np.random.default_rng([s & 0xFFFFFFFF, s >> 32, salt])


def perturbed(leaves: dict, seed: int, scale: float, keys) -> dict:
    """The starting parameters: each leaf of ``keys`` times
    (1 + scale * N(0, 1)), drawn from ``seed`` leaf by leaf in key order;
    the others as they are."""
    rng = _rng(seed, 0xF17)
    out = {k: np.asarray(v, np.float32) for k, v in leaves.items()}
    for key in sorted(keys):
        a = out[key]
        out[key] = (a * (1.0 + scale * rng.standard_normal(a.shape))
                    ).astype(np.float32)
    return out


class Session:
    def __init__(self, ctx):
        from hyper_ray_tracer_tpu_torch import build_scene
        from hyper_ray_tracer_tpu_torch.camera import make_basis
        from hyper_ray_tracer_tpu_torch.render import prepare_scene
        from hyper_ray_tracer_tpu_torch.scene_tensors import (
            extract_params, to_device)
        from hyper_ray_tracer_tpu_torch.train import (make_radiance_fn,
                                                      make_train_step,
                                                      pixel_lanes)

        self.ctx = ctx
        tr = ctx["traffic"]
        dev = self.device = ctx["device"]
        self.W, self.H = int(tr["width"]), int(tr["height"])
        self.spp, self.depth = int(tr["spp"]), int(tr["depth"])
        self.stride = int(tr.get("seed_stride", 1000))
        self.n_check = int(tr.get("check_steps", 3))
        self.share = float(tr.get("check_share", 0.4))
        self.lr = float(tr.get("learning_rate", 1e-2))
        self.scene = build_scene(ctx["config"]["scene"])
        arrays, structure, mode = prepare_scene(
            self.scene, tr.get("intersector", "auto"),
            int(tr.get("leaf_size", 4)))
        if mode != "sweep":
            # The reference reads the parameters in the scene's order.
            raise ValueError("the fit generator runs sweep-mode scenes only")
        self.scene_t = to_device(arrays, self.scene.static, dev, structure)
        self.basis = make_basis(self.scene.camera, self.W, self.H)
        self.pix, self.sam = pixel_lanes(self.W, self.H, self.spp, dev)
        # The inputs: the leaves of the reference's own build of the scene.
        self.base_leaves = scene_leaves(
            reference_scene(ctx["config"]["scene"]).arrays)
        program = {k: v.detach().cpu().numpy()
                   for k, v in extract_params(self.scene_t.arrays).items()}
        self.parted_leaves = sorted(
            k for k, v in self.base_leaves.items()
            if k not in program or program[k].shape != v.shape
            or not np.array_equal(program[k], v))
        self.start = perturbed(self.base_leaves, ctx["seed"],
                               float(tr.get("perturb", 1e-2)),
                               tr.get("perturb_leaves", self.base_leaves))
        kw = dict(intersector=mode, leaf_size=int(tr.get("leaf_size", 4)),
                  remat=bool(tr.get("remat", False)),
                  partition=bool(tr.get("partition", True)))
        if ctx["control"] == "bf16":
            # The lower-precision control: the program's own bf16 path.
            self.init, self.step = bf16_train_step(
                self.scene, self.W, self.H, self.depth, self.lr, kw)
        else:
            self.init, self.step = make_train_step(
                self.scene, self.W, self.H, self.depth,
                learning_rate=self.lr,
                silhouette=bool(tr.get("silhouette", False)), **kw)
        self.radiance = make_radiance_fn(self.scene, self.W, self.H,
                                         self.depth, **kw)
        # ``--fault name`` breaks every step, ``name@window`` the window's.
        fault = ctx["fault"] or ""
        self.fault, _, where = fault.partition("@")
        self.fault_from = self.n_check + 1 if where == "window" else 1
        self.readings = {}
        self.window = None

    def seed_of(self, k):
        return step_seed(self.ctx["seed"], self.stride, k)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm(self):
        with torch.no_grad():
            base = {k: torch.as_tensor(v, device=self.device)
                    for k, v in self.base_leaves.items()}
            rad, _ = self.radiance(base, self.scene_t, self.basis, self.pix,
                                   self.sam, self.seed_of(0))
            self.target = rad.reshape(self.spp, self.W * self.H, 3).mean(0)
            del rad
        self.state = self.init(self.scene_t)
        with torch.no_grad():
            for k, p in self.state.params.items():
                p.copy_(torch.as_tensor(self.start[k]))
        losses, grads, walls = [], None, []
        for k in range(1, self.n_check + 1):
            t0 = time.perf_counter()
            losses.append(self._step(k))
            walls.append(time.perf_counter() - t0)
            if k == 1:
                grads = self._first_grads()
        self._sync()
        change = {k: (p.detach().cpu().numpy() - self.start[k])
                  for k, p in self.state.params.items()}
        self.readings = dict(losses=losses, grads=grads, change=change)
        self.k = self.n_check
        # The window's step to check: one of the first ``share`` of the
        # steps the window should hold at the set-up steps' pace.
        wall = min(walls[1:] or walls)
        room = max(1, int(self.share * self.ctx["seconds"] / wall))
        self.check_at = self.n_check + 1 + int(
            _rng(self.ctx["seed"], 0xC4EC).integers(room))

    def _first_grads(self):
        """The first gradient as adam got it: m_1 / (1 - beta1)."""
        opt = self.state.optimizer
        out = {}
        for k, p in self.state.params.items():
            m = opt.state.get(p, {}).get("exp_avg", torch.zeros_like(p))
            out[k] = (m / (1.0 - ADAM_BETAS[0])).detach().cpu().numpy()
        return out

    def _copy(self):
        """The parameters, adam's moments and its step count, on the host
        in float64."""
        opt = self.state.optimizer
        out = {}
        for k, p in self.state.params.items():
            st = opt.state.get(p, {})

            def host(t):
                return (t.detach().double().cpu().numpy() if t is not None
                        else np.zeros(p.shape))
            out[k] = dict(p=host(p), m=host(st.get("exp_avg")),
                          v=host(st.get("exp_avg_sq")),
                          t=float(st.get("step", 0)))
        return out

    def _step(self, k):
        fault = self.fault if k >= self.fault_from else None
        with faults.fit_fault(fault or None, self.state):
            self.state, loss = self.step(self.state, self.scene_t,
                                         self.basis, self.pix, self.sam,
                                         self.seed_of(k), self.target)
        self._sync()
        return loss.item()

    def run(self, i):
        self.k += 1
        if self.k != self.check_at:
            self._step(self.k)
            return 1
        before = self._copy()
        loss = self._step(self.k)
        self.window = dict(k=self.k, loss=loss, before=before,
                           after=self._copy())
        return 1

    def pending(self):
        """The window's drawn step has not run yet: the window goes on
        until it has (at the set-up's pace it falls in the first 40%)."""
        return self.window is None

    def traced(self, loop):
        events, records, window = capture(loop, self.device)
        work = {"steps": len(records),
                "camera_rays": len(records) * self.W * self.H * self.spp}
        out = merge([summarize(events, work)])
        print("traced: kernels {kernel_us!r} us, of them linked "
              "{linked_us!r}, off the ranges' thread {off_range_us!r}; "
              "ranges {range_us!r}".format(**out), file=sys.stderr)
        return out, window

    def end_to_end(self, records, window_s):
        walls = [e - s for s, e, _ in records]
        out = {"fit_step_s": window_s / len(records)}
        out["fit_step_p90_s"] = (statistics.quantiles(walls, n=10)[8]
                                 if len(walls) >= 2 else walls[0])
        print(f"{len(walls)} steps in the window", file=sys.stderr)
        return out

    def device_info(self):
        return device_info(self.device, self.ctx["chips"])

    def free(self):
        self.state = self.scene_t = self.target = None
        self._sync()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self):
        lim = self.ctx["limits"]
        steps = int(lim.get("reference_steps", self.n_check))
        block = int(lim.get("pixel_block", 1 << 15))
        still = float(lim.get("still_grad", 1e-3))
        name = self.ctx["config"]["scene"]
        failed = 0
        if self.parted_leaves:
            print("the program's leaves part from the scene as built: "
                  + ", ".join(self.parted_leaves), file=sys.stderr)
            failed += 1
        ref = for_scene(name, self.device)
        target = reference_target(ref, self, block)
        follow = reference_fit(ref, self, target, steps, block)
        prog = self.readings
        ref_w = reference_window(ref, self, target, self.window, block)
        if self.ctx["control"] == "ref_bf16":
            # The control in the program's place: the reference in bfloat16.
            ctrl = for_scene(name, self.device, dtype=torch.bfloat16)
            ctrl_target = reference_target(ctrl, self, block)
            prog = reference_fit(ctrl, self, ctrl_target, self.n_check,
                                 block)
            prog_w = reference_window(ctrl, self, ctrl_target, self.window,
                                      block)
        else:
            prog_w = program_window(self.window)
        numbers = compare(prog, follow, steps, still)
        numbers.update(compare_window(prog_w, ref_w, still))
        for key, v in numbers.items():
            v["limit"] = float(lim["numbers"][key]["limit"])
        return numbers, failed


def bf16_train_step(scene, W, H, depth, lr, kw):
    """``make_train_step``'s step with the bf16 candidate tests on: its
    loss as ``train.make_loss_fn`` builds it, over the radiance of
    ``train.make_radiance_fn(..., bf16_hits=True)``."""
    from hyper_ray_tracer_tpu_torch.train import (make_radiance_fn,
                                                  train_step_of)

    radiance = make_radiance_fn(scene, W, H, depth, bf16_hits=True, **kw)

    def loss_fn(params, scene_t, basis, pixel_ids, sample_ids, seed, target):
        rad, _ = radiance(params, scene_t, basis, pixel_ids, sample_ids,
                          seed)
        mean = rad.reshape(pixel_ids.shape[0], W * H, 3).mean(0)
        return ((mean - target) ** 2).mean()

    loss_fn.schedule = radiance.schedule
    return train_step_of(loss_fn, lr)


def reference_target(ref, s, pixel_block: int) -> torch.Tensor:
    """The reference's target: each pixel's mean radiance of the scene's
    own leaves at RNG seed k = 0."""
    n_pix = s.W * s.H
    target = torch.zeros((n_pix, 3), dtype=torch.float32, device=ref.device)
    base = {k: torch.as_tensor(v, device=ref.device)
            for k, v in s.base_leaves.items()}
    with torch.no_grad():
        for p0 in range(0, n_pix, pixel_block):
            target[p0:p0 + pixel_block] = _pixel_mean(
                ref, s.W, s.H, p0, min(n_pix, p0 + pixel_block), s.spp,
                s.seed_of(0), s.depth, base)
    return target


def reference_loss_grad(ref, s, target, params, k, pixel_block: int):
    """The reference's loss and gradients (float64 NumPy) of step k from
    ``params`` (leaf tensors)."""
    n_pix = s.W * s.H
    leaves = {key: p.clone().requires_grad_() for key, p in params.items()}
    total = 0.0
    for p0 in range(0, n_pix, pixel_block):
        p1 = min(n_pix, p0 + pixel_block)
        mean = _pixel_mean(ref, s.W, s.H, p0, p1, s.spp, s.seed_of(k),
                           s.depth, leaves)
        part = ((mean - target[p0:p1]) ** 2).sum() / (n_pix * 3)
        if part.requires_grad:  # a block of sky alone reads no leaf
            part.backward()
        total += float(part.detach())
    return total, {key: (x.grad.double().cpu().numpy() if x.grad is not None
                         else np.zeros(x.shape)) for key, x in leaves.items()}


def adam_update(g, m, v, t, lr):
    """Adam's (m, v, update) from moments m, v after t steps, gradient g."""
    b1, b2 = ADAM_BETAS
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * g * g
    mh = m / (1 - b1 ** (t + 1))
    vh = v / (1 - b2 ** (t + 1))
    return m, v, -lr * mh / (np.sqrt(vh) + ADAM_EPS)


def reference_fit(ref, s, target, steps: int, pixel_block: int) -> dict:
    """The reference's losses, first gradients and parameter change over
    ``steps`` adam steps from the start, with the set-up's step seeds."""
    params = {k: np.asarray(v, np.float64) for k, v in s.start.items()}
    m = {k: np.zeros_like(v) for k, v in params.items()}
    v2 = {k: np.zeros_like(v) for k, v in params.items()}
    losses, grads = [], None
    for k in range(1, steps + 1):
        loss, g = reference_loss_grad(
            ref, s, target, {key: torch.as_tensor(p, dtype=torch.float32,
                                                  device=ref.device)
                             for key, p in params.items()}, k, pixel_block)
        losses.append(loss)
        if k == 1:
            grads = g
        for key in params:
            m[key], v2[key], upd = adam_update(g[key], m[key], v2[key],
                                               k - 1, s.lr)
            params[key] = params[key] + upd
    change = {key: params[key] - s.start[key] for key in params}
    return dict(losses=losses, grads=grads, change=change)


def reference_window(ref, s, target, window: dict, pixel_block: int) -> dict:
    """The reference's loss, gradient and adam update of the window's
    step, from the program's parameters and moments before it."""
    before = window["before"]
    params = {k: torch.as_tensor(b["p"], dtype=torch.float32,
                                 device=ref.device)
              for k, b in before.items()}
    loss, g = reference_loss_grad(ref, s, target, params, window["k"],
                                  pixel_block)
    update = {k: adam_update(g[k], b["m"], b["v"], b["t"], s.lr)[2]
              for k, b in before.items()}
    return dict(loss=loss, grads=g, update=update)


def program_window(window: dict) -> dict:
    """The program's loss, gradient as adam got it, and update of the
    window's step, from the copies around it."""
    b1 = ADAM_BETAS[0]
    before, after = window["before"], window["after"]
    grads = {k: (after[k]["m"] - b1 * before[k]["m"]) / (1 - b1)
             for k in before}
    update = {k: after[k]["p"] - before[k]["p"] for k in before}
    return dict(loss=window["loss"], grads=grads, update=update)


def _pixel_mean(ref, W, H, p0, p1, spp, seed, depth, leaves):
    dev = ref.device
    pix = torch.arange(p0, p1, device=dev)
    lanes_p = pix.repeat(spp)
    lanes_s = torch.arange(spp, device=dev).repeat_interleave(p1 - p0)
    rad = ref.radiance(W, H, lanes_p, lanes_s, seed, depth, params=leaves)
    return rad.float().reshape(spp, p1 - p0, 3).mean(0)


def _kept(ref_grads: dict, still: float) -> list:
    """Leaves whose reference gradient is neither 0 nor under ``still``
    times the median leaf's (the others move under adam by round-off)."""
    gnorm = {k: float(np.linalg.norm(v)) for k, v in ref_grads.items()}
    med = float(np.nanmedian(list(gnorm.values())))
    keep = [k for k, v in gnorm.items() if v > 0.0 and v >= still * med]
    print("leaves compared: " + ", ".join(keep) + "; left out: "
          + ", ".join(sorted(set(gnorm) - set(keep))), file=sys.stderr)
    return keep


def _worst(a: dict, b: dict, keep: list) -> float:
    """The worst leaf's |norm(a) - norm(b)| over the larger of norm(b) and
    the median leaf's norm(b)."""
    na = {k: float(np.linalg.norm(a[k])) for k in keep}
    nb = {k: float(np.linalg.norm(b[k])) for k in keep}
    scale = float(np.median(list(nb.values())))
    gaps = [abs(na[k] - nb[k]) / max(nb[k], scale) for k in keep]
    return max(g if np.isfinite(g) else float("inf") for g in gaps)


def _loss_gap(a: float, b: float) -> float:
    gap = abs(a - b) / abs(b)
    return gap if np.isfinite(gap) else float("inf")


def compare(prog: dict, refr: dict, steps: int, still: float) -> dict:
    """The set-up's numbers: the worst step's relative loss gap; the worst
    leaf's gap between the first gradients' norms and between the
    parameter changes' norms."""
    loss_gap = max(_loss_gap(a, b) for a, b in
                   zip(prog["losses"][:steps], refr["losses"]))
    for side, r in (("program", prog), ("reference", refr)):
        bad = {k: int((~np.isfinite(v)).sum()) for what in ("grads", "change")
               for k, v in ((f"{what}:{k}", v) for k, v in r[what].items())
               if (~np.isfinite(v)).any()}
        print(f"{side}: losses {r['losses']}; non-finite {bad or 'none'}",
              file=sys.stderr)
    keep = _kept(refr["grads"], still)
    out = {"loss_gap": {"value": loss_gap},
           "grad_norm_gap": {"value": _worst(prog["grads"], refr["grads"],
                                             keep)}}
    if steps == len(prog["losses"]):
        out["change_norm_gap"] = {"value": _worst(prog["change"],
                                                  refr["change"], keep)}
    return out


def compare_window(prog: dict, refr: dict, still: float) -> dict:
    """The window's step: its relative loss gap, and the worst leaf's gap
    between the gradients' norms and between adam's updates' norms."""
    print(f"window step: loss {prog['loss']!r} (reference "
          f"{refr['loss']!r})", file=sys.stderr)
    keep = _kept(refr["grads"], still)
    return {"window_loss_gap": {"value": _loss_gap(prog["loss"],
                                                   refr["loss"])},
            "window_grad_norm_gap": {"value": _worst(
                prog["grads"], refr["grads"], keep)},
            "window_update_norm_gap": {"value": _worst(
                prog["update"], refr["update"], keep)}}
