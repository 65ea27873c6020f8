"""Packet-size and occupancy sweep of the sweep kernels on one GPU:
``python3 tune_sweeps.py``.

Builds copies of ``hyper_ray_tracer_tpu_torch/csrc`` with another ray
packet size (``kRays``, R), threads per block (``kThreads``) and
resident-block floor (``kMinBlocks``, which caps ptxas's registers per
thread) into ``build/tune/``, and times K1 (``random``'s 1280x720 camera
rays) and K1b (``final``'s 400x225x16 and ``random``'s camera rays) in
two rounds on one card.  Each variant's output is checked against the
plain versions, bit for bit.  Prints one line per kernel build
(registers, stack frame and spill bytes per kernel, from ``-Xptxas -v``)
and one per variant and round.  Each kernel ships the fastest variant
without spills.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "hyper_ray_tracer_tpu_torch" / "csrc"
OUT = ROOT / "build" / "tune"
# (rays per thread, threads per block, resident-block floor): an SM has
# 65536 registers, so the floor b caps a thread at 65536 / (threads * b).
VARIANTS = tuple((4, 128, b) for b in (4, 5, 6, 7, 8)) + \
    ((4, 256, 2), (4, 256, 3)) + tuple((2, 128, b) for b in (4, 6, 8))
KERNELS = ("sphere_sweep", "typed_sweep")


def variant_sources(rays, threads, min_blocks):
    """A copy of csrc/ with the three constants replaced."""
    d = OUT / f"r{rays}_t{threads}_b{min_blocks}"
    d.mkdir(parents=True, exist_ok=True)
    for f in SRC.iterdir():
        text = f.read_text()
        for name, value in (("kRays", rays), ("kThreads", threads),
                            ("kMinBlocks", min_blocks)):
            text = re.sub(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text)
        (d / f.name).write_text(text)
    return d


def main() -> int:
    if not torch.cuda.is_available():
        print("tune_sweeps: no CUDA device is available", file=sys.stderr)
        return 1
    from hyper_ray_tracer_tpu_torch import build_scene
    from hyper_ray_tracer_tpu_torch.camera import make_basis
    from hyper_ray_tracer_tpu_torch.ops import rng as prng
    from hyper_ray_tracer_tpu_torch.ops import sphere_sweep as k1
    from hyper_ray_tracer_tpu_torch.ops import typed_sweep as k1b
    from hyper_ray_tracer_tpu_torch.render import init_state
    from hyper_ray_tracer_tpu_torch.scene_tensors import to_device
    from hyper_ray_tracer_tpu_torch.utils import cuda_build

    nvcc = cuda_build.find_nvcc()

    def build(job):
        d, kernel = job
        lib = d / f"lib{kernel}.so"
        proc = subprocess.run([nvcc, *cuda_build.NVCC_FLAGS, "-o", str(lib),
                               str(d / f"{kernel}.cu")],
                              capture_output=True, text=True, timeout=600)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {d.name}/{kernel}:\n{log}")
        return lib, list(zip(re.findall(r"Used (\d+) registers", log),
                             re.findall(r"(\d+) bytes stack frame", log),
                             re.findall(r"(\d+) bytes spill stores", log)))

    jobs = [(variant_sources(*v), k) for v in VARIANTS for k in KERNELS]
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = list(pool.map(build, jobs))
    libs = {}
    for (d, kernel), (lib, regs) in zip(jobs, built):
        print(f"{d.name} {kernel}: (registers, stack frame bytes, spill "
              f"bytes) per kernel {regs}", flush=True)
        libs[d.name, kernel] = ctypes.CDLL(str(lib))

    dev = torch.device("cuda")

    def camera(name, w, h, spp):
        scene = build_scene(name)
        st = to_device(scene.arrays, scene.static, dev)
        pix = torch.arange(w * h, device=dev).repeat(spp)
        smp = torch.arange(spp, device=dev).repeat_interleave(w * h)
        s = init_state(make_basis(scene.camera, w, h), w, h, pix, smp, 0)
        rays = (s.o.contiguous(), s.d.contiguous(), s.time.contiguous(),
                s.alive.contiguous())
        return st, rays, prng.bounce_base(s.base, 0).contiguous()

    rnd, rnd_rays, rnd_bits = camera("random", 1280, 720, 1)
    fin, fin_rays, fin_bits = camera("final", 400, 225, 16)
    cases = {
        "K1 random": (k1.sphere_sweep, k1.sphere_sweep_plain,
                      (*rnd.spheres, *rnd_rays)),
        "K1b final": (k1b.typed_sweep, k1b.typed_sweep_plain,
                      (fin.sweep, *fin_rays, fin_bits)),
        "K1b random": (k1b.typed_sweep, k1b.typed_sweep_plain,
                       (rnd.sweep, *rnd_rays, rnd_bits)),
    }
    plain = {k: plain_fn(*args) for k, (_, plain_fn, args) in cases.items()}

    def time_ms(fn, args, reps=20):
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

    load = cuda_build.load
    try:
        for round_i in range(2):
            for d, _ in jobs[::len(KERNELS)]:
                cuda_build.load = lambda kernel, d=d: libs[d.name, kernel]
                times = []
                for label, (fn, _, args) in cases.items():
                    if round_i == 0:
                        got = fn(*args)
                        assert all(torch.equal(x, y) for x, y in
                                   zip(got, plain[label])), (d.name, label)
                    times.append(f"{label} {time_ms(fn, args):.4f} ms")
                print(f"round {round_i} {d.name}: " + ", ".join(times),
                      flush=True)
    finally:
        cuda_build.load = load
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
