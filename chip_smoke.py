"""Smoke run of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Builds the port's CUDA kernel from the checkout, holds it against its
plain-PyTorch version on the card, renders the `random` golden through it,
then drives the CLI's default workload (`random`, 1280x720, 100 spp,
depth 10) and checks the PNG it writes.  Each phase prints one line; any
failure ends the run with a non-zero exit.  The last three lines are the
card's name and power limit (nvidia-smi), one JSON object per kernel of
the path, and ``{"ok": true, "device": {...}}``.

Exits non-zero without a result when no CUDA device is available, and
when the port's package is not beside this script.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
BIG = float(np.float32(3.0e38))
T_MIN = 1.0e-3


def phase(n, msg):
    print(f"[phase {n}] {msg}", flush=True)


def nvidia_smi():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def sweep_rules(t_k, b_k, t_p, b_p, active):
    """tests/test_pallas_sweep.py's rules (winner agreement > 0.999, a flip
    only on a near-tie, matched t to rtol 5e-4 / atol 1e-3), and inactive
    rays at (BIG, -1).  Returns (agreement, exact share, max |dt|)."""
    match = b_k == b_p
    agree = match.float().mean().item()
    assert agree > 0.999, f"winner agreement {agree:.6f}"
    flip = ~match & (b_k >= 0) & (b_p >= 0)
    if flip.any():
        torch.testing.assert_close(t_k[flip], t_p[flip], rtol=1e-3, atol=0)
    hit = match & (b_p >= 0)
    torch.testing.assert_close(t_k[hit], t_p[hit], rtol=5e-4, atol=1e-3)
    off = ~active
    assert (b_k[off] == -1).all() and (t_k[off] == BIG).all(), \
        "an inactive ray did not return (BIG, -1)"
    exact = (match & (t_k == t_p)).float().mean().item()
    return agree, exact, (t_k[hit] - t_p[hit]).abs().max().item()


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from hyper_ray_tracer_tpu_torch import RenderSettings, build_scene
    from hyper_ray_tracer_tpu_torch import render_image
    from hyper_ray_tracer_tpu_torch.__main__ import main as cli_main
    from hyper_ray_tracer_tpu_torch.camera import make_basis
    from hyper_ray_tracer_tpu_torch.ops.sphere_sweep import (
        sphere_sweep,
        sphere_sweep_plain,
    )
    from hyper_ray_tracer_tpu_torch.render import bounce_step, init_state
    from hyper_ray_tracer_tpu_torch.scene_tensors import to_device
    from hyper_ray_tracer_tpu_torch.utils import cuda_build
    from hyper_ray_tracer_tpu_torch.utils.image import read_png

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()

    # Phase 1: device and kernel build.
    t0 = time.monotonic()
    lib = cuda_build.build("sphere_sweep")
    build_s = time.monotonic() - t0
    cuda_build.load("sphere_sweep")
    ptxas = [ln.strip() for ln in
             Path(str(lib) + ".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    phase(1, f"device {kind!r} count {torch.cuda.device_count()} | "
          f"nvidia-smi: {smi} | sphere_sweep built in {build_s:.2f} s "
          f"({'; '.join(ptxas)})")

    # Phase 2: kernel against its plain version on the card.
    def camera(scene, W, H, pixel_ids, sample_ids):
        return init_state(make_basis(scene.camera, W, H), W, H, pixel_ids,
                          sample_ids, 0)

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
    random_t = cases[0][1]
    half = torch.arange(W * H, device=dev) % 2 == 0
    cases.append(("random camera, half inactive", random_t, cases[0][2],
                  cases[0][3], cases[0][4], half))
    n_odd = 1_000_003
    ids = torch.arange(n_odd, dtype=torch.int64, device=dev)
    odd = camera(build_scene("random"), W, H, ids % (W * H), ids // (W * H))
    cases.append((f"random camera N={n_odd}", random_t, odd.o, odd.d,
                  odd.time, odd.alive))
    max_err, agreements = 0.0, []
    for label, st, o, d, tm, active in cases:
        args = (*st.spheres, o.contiguous(), d.contiguous(),
                tm.contiguous(), active.contiguous(), T_MIN)
        t_k, b_k = sphere_sweep(*args)
        torch.cuda.synchronize()
        t_p, b_p = sphere_sweep_plain(*args)
        torch.cuda.synchronize()
        agree, exact, err = sweep_rules(t_k, b_k, t_p, b_p, active)
        agreements.append(f"{label}: {agree:.6f} (bit-equal {exact:.6f})")
        max_err = max(max_err, err)
    main_args = (*random_t.spheres, cases[0][2], cases[0][3], cases[0][4],
                 cases[0][5], T_MIN)
    # Turns (plain, kernel, kernel, plain) on one card.
    p1 = time_ms(sphere_sweep_plain, main_args, 3)
    k1 = time_ms(sphere_sweep, main_args, 20)
    k2 = time_ms(sphere_sweep, main_args, 20)
    p2 = time_ms(sphere_sweep_plain, main_args, 3)
    kernel_ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    phase(2, f"sphere_sweep vs plain: winner agreement "
          f"[{'; '.join(agreements)}], max |dt| on matched hits "
          f"{max_err:.3e}; at N=921600 P=486 kernel {kernel_ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms")

    # Phase 3: the `random` golden rendered on the card through the kernel.
    before = sphere_sweep.launches
    golden = np.load(ROOT / "tests" / "golden" /
                     "random_160x90_2spp_d8.npy")
    img = render_image(build_scene("random"),
                       RenderSettings(160, 90, 2, 8), dev)
    torch.cuda.synchronize()
    launched = sphere_sweep.launches - before
    assert launched > 0, "the golden render did not launch the kernel"
    err = np.abs(img - golden)
    med, mean, outl = (float(np.median(err)), float(err.mean()),
                       float(np.mean(err > 3e-2)))
    assert med < 1e-3 and mean < 4e-3 and outl < 0.02, (med, mean, outl)
    phase(3, f"random 160x90 2spp d8 on {kind}: median err {med:.3e}, "
          f"mean err {mean:.3e}, outliers {outl:.4f} "
          f"(bounds 1e-3 / 4e-3 / 0.02); {launched} kernel launches")

    # Phase 4: the CLI's default workload (random, 1280x720, 100 spp,
    # depth 10) through the entry point a user calls.
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "random.png"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sphere_sweep.launches = 0
        t0 = time.monotonic()
        rc = cli_main(["--output", str(out)])
        wall = time.monotonic() - t0
        launches = sphere_sweep.launches
        assert rc == 0, f"CLI exit code {rc}"
        assert launches > 0, "the main path never launched sphere_sweep"
        png = read_png(out)
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
          f"{launches} sphere_sweep launches, peak device memory "
          f"{peak_gb:.2f} GB, PNG mean {lum:.1f}")

    kernels = [{
        "name": "sphere_sweep",
        "route": "cuda",
        "source": "hyper_ray_tracer_tpu_torch/csrc/sphere_sweep.cu",
        "replaces": "hyper_ray_tracer_tpu/ops/pallas_sweep.py:38",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]
    print(nvidia_smi())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
