"""Launch-shape sweep of the cluster sweep K5 on one GPU:
``python3 tune_cluster.py``.

Builds copies of ``hyper_ray_tracer_tpu_torch/csrc`` with other values
of K5's two launch constants into ``build/tune_cluster/``: rays a block
(``kWarps``, a warp a ray) and the resident-block floor
(``kMinBlocks``, which caps ptxas's registers per thread; 0 sets none).
Times each, in two rounds on one card, on `sphereflake`'s 1280x720
camera rays and on bounce 1 of one full chunk of its CLI default (the
6.4M lanes that survive bounce 0), each output checked against
``cluster_sweep_plain`` bit for bit.  Prints one line per build
(registers, stack frame and spill bytes, from ``-Xptxas -v``) and one per
variant and round.  K5 ships the fastest variant without spills.
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
OUT = ROOT / "build" / "tune_cluster"
# (rays a block, resident-block floor): an SM has 65536 registers, so the
# floor b caps a thread at 65536 / (32 * rays * b).
VARIANTS = tuple((4, b) for b in (0, 6, 7, 8)) + ((8, 3), (8, 4))


def variant_sources(warps, min_blocks):
    """A copy of csrc/ with K5's two launch constants replaced."""
    d = OUT / f"w{warps}_b{min_blocks}"
    d.mkdir(parents=True, exist_ok=True)
    for f in SRC.iterdir():
        text = f.read_text()
        if f.name == "cluster_sweep.cu":
            for name, value in (("kWarps", warps),
                                ("kMinBlocks", min_blocks)):
                text, n = re.subn(rf"constexpr int {name} = \d+;",
                                  f"constexpr int {name} = {value};", text)
                assert n == 1, name
        (d / f.name).write_text(text)
    return d


def main() -> int:
    if not torch.cuda.is_available():
        print("tune_cluster: no CUDA device is available", file=sys.stderr)
        return 1
    from hyper_ray_tracer_tpu_torch import (
        RenderSettings,
        build_scene,
        prepare_scene,
    )
    from hyper_ray_tracer_tpu_torch.camera import make_basis
    from hyper_ray_tracer_tpu_torch.ops import cluster_sweep as k5
    from hyper_ray_tracer_tpu_torch.ops import rng as prng
    from hyper_ray_tracer_tpu_torch.render import (
        T_MIN,
        bounce_step,
        init_state,
        spp_per_chunk,
    )
    from hyper_ray_tracer_tpu_torch.scene_tensors import to_device
    from hyper_ray_tracer_tpu_torch.utils import cuda_build

    nvcc = cuda_build.find_nvcc()

    def build(d):
        lib = d / "libcluster_sweep.so"
        proc = subprocess.run([nvcc, *cuda_build.NVCC_FLAGS, "-o", str(lib),
                               str(d / "cluster_sweep.cu")],
                              capture_output=True, text=True, timeout=600)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {d.name}:\n{log}")
        return lib, list(zip(re.findall(r"Used (\d+) registers", log),
                             re.findall(r"(\d+) bytes stack frame", log),
                             re.findall(r"(\d+) bytes spill stores", log)))

    dirs = [variant_sources(*v) for v in VARIANTS]
    with ThreadPoolExecutor(len(dirs)) as pool:
        built = list(pool.map(build, dirs))
    libs = {}
    for d, (lib, regs) in zip(dirs, built):
        print(f"{d.name}: (registers, stack frame bytes, spill bytes) "
              f"{regs}", flush=True)
        libs[d.name] = ctypes.CDLL(str(lib))

    dev = torch.device("cuda")
    scene = build_scene("sphereflake")
    arrays, layout, _ = prepare_scene(scene, "cluster")
    st = to_device(arrays, scene.static, dev, layout)

    def rays(spp, bounces):
        w, h = 1280, 720
        pix = torch.arange(w * h, device=dev).repeat(spp)
        smp = torch.arange(spp, device=dev).repeat_interleave(w * h)
        s = init_state(make_basis(scene.camera, w, h), w, h, pix, smp, 0)
        for b in range(bounces):
            s = bounce_step(st, scene.background, s, b)
            keep = s.alive.nonzero().squeeze(1)
            s = type(s)(*(x.index_select(0, keep) for x in s))
        return (st.cluster, *(x.contiguous() for x in (
            s.o, s.d, s.time, s.alive, prng.bounce_base(s.base, bounces))),
            T_MIN)

    cases = {"camera": rays(1, 0),
             "chunk bounce 1": rays(spp_per_chunk(
                 RenderSettings(1280, 720, 100, 10)), 1)}
    plain = {k: k5.cluster_sweep_plain(*a) for k, a in cases.items()}

    def time_ms(args, reps=10):
        k5.cluster_sweep(*args)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            k5.cluster_sweep(*args)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    load = cuda_build.load
    try:
        for round_i in range(2):
            for d in dirs:
                cuda_build.load = lambda kernel, d=d: libs[d.name]
                times = []
                for label, args in cases.items():
                    if round_i == 0:
                        got = k5.cluster_sweep(*args)
                        assert all(torch.equal(x, y) for x, y in
                                   zip(got, plain[label])), (d.name, label)
                    times.append(f"{label} {time_ms(args):.4f} ms")
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
