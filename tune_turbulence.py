"""Layout and occupancy sweep of the noise-texture kernels K2 and K2b on
one GPU: ``python3 tune_turbulence.py``.

Builds copies of ``hyper_ray_tracer_tpu_torch/csrc/turbulence.cu`` with
another number of gradient-table copies in shared memory (``kCopies``),
flags per thread and tile (``kSteps``), resident-block floor of K2
(``kMinBlocks``) and of K2b (``kGradMinBlocks``), and octaves a trip of
K2b's octave loop (``kGradUnroll``) into ``build/tune_turbulence/``,
checks each on the inputs of `final`'s first bounce at the bench shape
(400x225x16): K2 against ``noise_texture_plain`` bit for bit, K2b (on
what the shipped K2 saved) against ``noise_texture_grad_plain`` within
chip_smoke.py's K2B_SHARE, and times both on the device (the profiler's
kernel durations) with `final`'s real noise mask and with every lane
noise, in two rounds on one card.  Prints one line per variant and
round, with each kernel's registers, shared memory and spills
(``-Xptxas -v``).  The kernels ship the fastest variant without spills.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from chip_smoke import K2B_SHARE, device_ms, nvidia_smi, ptxas_report

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "hyper_ray_tracer_tpu_torch" / "csrc" / "turbulence.cu"
OUT = ROOT / "build" / "tune_turbulence"
# (gradient copies, flags per thread, K2's resident-block floor, K2b's,
# K2b's octaves a trip); the first is the shipped kernels.  Static shared
# memory (at most 48 KB) is 16 bytes x 256 x copies + 4 bytes x 256 x
# (3 + steps) + a little.  K2's own layout was tuned with K2 alone (4, 4,
# 4 of 10 variants); the rest vary what K2b's redesign opened: its
# register budget (64 registers a thread at 4 resident blocks of 256, 80
# at 3, 128 at 2) and its octave loop's unrolling (7: the whole loop).
VARIANTS = ((4, 4, 4, 3, 1), (4, 4, 4, 2, 1), (4, 4, 4, 3, 2),
            (4, 4, 4, 4, 1), (4, 4, 4, 2, 2), (4, 4, 4, 4, 2),
            (4, 4, 4, 2, 7), (4, 4, 4, 3, 7), (8, 4, 4, 3, 1),
            (1, 4, 4, 3, 1), (4, 8, 4, 3, 1))
NAMES = ("kCopies", "kSteps", "kMinBlocks", "kGradMinBlocks", "kGradUnroll")


def variant_source(*values):
    """A copy of turbulence.cu with the constants of NAMES replaced."""
    text = SRC.read_text()
    for name, value in zip(NAMES, values):
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text)
        assert n == 1, name
    path = (OUT / "c{}_s{}_b{}_g{}_u{}".format(*values)) / SRC.name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text)
    return path


def main() -> int:
    if not torch.cuda.is_available():
        print("tune_turbulence: no CUDA device is available",
              file=sys.stderr)
        return 1
    from hyper_ray_tracer_tpu_torch import build_scene
    from hyper_ray_tracer_tpu_torch.camera import make_basis
    from hyper_ray_tracer_tpu_torch.models.scene import TT_NOISE
    from hyper_ray_tracer_tpu_torch.ops import rng as prng
    from hyper_ray_tracer_tpu_torch.ops.intersect import (
        gather_prim_shade_packed,
        hit_detail,
    )
    from hyper_ray_tracer_tpu_torch.ops.turbulence import (
        noise_texture,
        noise_texture_grad,
        noise_texture_grad_plain,
        noise_texture_plain,
        noise_texture_saved,
    )
    from hyper_ray_tracer_tpu_torch.render import init_state, trace
    from hyper_ray_tracer_tpu_torch.scene_tensors import to_device
    from hyper_ray_tracer_tpu_torch.utils import cuda_build

    nvcc = cuda_build.find_nvcc()

    def build(src):
        lib = src.parent / "libturbulence.so"
        proc = subprocess.run([nvcc, *cuda_build.NVCC_FLAGS, "-I",
                               str(SRC.parent), "-o", str(lib), str(src)],
                              capture_output=True, text=True, timeout=600)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.parent.name}:\n{log}")
        return (ctypes.CDLL(str(lib)), "; ".join(
            f"{k} {r} registers, {sm} B smem, {sp} B spilled"
            for k, (r, sm, sp) in ptxas_report(log).items()))

    sources = [variant_source(*v) for v in VARIANTS]
    with ThreadPoolExecutor(len(sources)) as pool:
        built = dict(zip(sources, pool.map(build, sources)))

    dev = torch.device("cuda")
    scene = build_scene("final")
    st = to_device(scene.arrays, scene.static, dev)
    w, h, spp = 400, 225, 16
    pix = torch.arange(w * h, device=dev).repeat(spp)
    smp = torch.arange(spp, device=dev).repeat_interleave(w * h)
    s = init_state(make_basis(scene.camera, w, h), w, h, pix, smp, 0)
    t_hit, prim = trace(st, s, prng.bounce_base(s.base, 0))
    pidx = torch.clamp(prim, min=0).long()
    pf, sf = gather_prim_shade_packed(st.fpack, st.ipack, pidx, scene.static)
    det = hit_detail(pf, s.o, s.d, s.time,
                     torch.where(prim >= 0, t_hit, 1.0), scene.static)
    gi = st.ipack[pidx]
    every = gi.clone()
    every[:, 5] = TT_NOISE
    cases = {label: (rows[:, 5], sf.scale, det.point, sf.color1, st.tables)
             for label, rows in (("real mask", gi), ("all-true", every))}
    plain = {k: noise_texture_plain(*args) for k, args in cases.items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    grad_out = torch.rand(det.point.shape, device=dev, generator=gen) - 0.5
    grad_cases = {k: (args[0], args[1], args[2], grad_out, st.tables)
                  for k, args in cases.items()}
    grad_plain = {k: noise_texture_grad_plain(*args)
                  for k, args in grad_cases.items()}
    saved = {k: noise_texture_saved(*args)[1] for k, args in cases.items()}

    load = cuda_build.load
    try:
        for round_i in range(2):
            for src in sources:
                lib, resources = built[src]
                cuda_build.load = lambda name, lib=lib: lib
                times = []
                for label, args in cases.items():
                    if round_i == 0:
                        assert torch.equal(noise_texture(*args),
                                           plain[label]), (src, label)
                    times.append(f"K2 {label} "
                                 f"{device_ms(noise_texture, args, 20):.4f}"
                                 " ms")
                for label, args in grad_cases.items():

                    def k2b(ttype, *a, saved=saved[label]):
                        return noise_texture_grad(*a, saved)

                    if round_i == 0:
                        got, ref = k2b(*args), grad_plain[label]
                        assert torch.equal(got[2], ref[2]), (src, label)
                        for g, r in zip(got[:2], ref[:2]):
                            assert (g - r).abs().max() <= \
                                K2B_SHARE * r.abs().max(), (src, label)
                    times.append(f"K2b {label} "
                                 f"{device_ms(k2b, args, 20):.4f} ms")
                print(f"round {round_i} {src.parent.name} ({resources}): "
                      + ", ".join(times), flush=True)
    finally:
        cuda_build.load = load
    print(nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
