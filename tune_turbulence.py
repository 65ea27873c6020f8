"""Layout and occupancy sweep of the noise-texture kernel K2 on one GPU:
``python3 tune_turbulence.py``.

Builds copies of ``hyper_ray_tracer_tpu_torch/csrc/turbulence.cu`` with
another number of gradient-table copies in shared memory (``kCopies``),
flags per thread and tile (``kSteps``) and resident-block floor
(``kMinBlocks``) into ``build/tune_turbulence/``, checks each against
``noise_texture_plain`` bit for bit on the inputs of `final`'s first
bounce at the bench shape (400x225x16), and times each on the device
(the profiler's kernel durations) with `final`'s real noise mask and
with every lane noise, in two rounds on one card.  Prints one line per
variant and round, with its registers, shared memory and spills
(``-Xptxas -v``).  The kernel ships the fastest variant without spills.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from chip_smoke import device_ms, nvidia_smi

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "hyper_ray_tracer_tpu_torch" / "csrc" / "turbulence.cu"
OUT = ROOT / "build" / "tune_turbulence"
# (gradient copies, flags per thread, resident-block floor); the first is
# the shipped kernel, the second the first design.  Static shared memory
# (at most 48 KB) is 16 bytes x 256 x copies + 4 bytes x 256 x (3 +
# steps) + a little.
VARIANTS = ((4, 4, 4), (8, 8, 1), (8, 4, 1), (1, 8, 1), (4, 8, 1),
            (4, 16, 1), (8, 4, 4), (8, 8, 4), (1, 4, 4), (4, 8, 6))


def variant_source(copies, steps, min_blocks):
    """A copy of turbulence.cu with the three constants replaced."""
    text = SRC.read_text()
    for name, value in (("kCopies", copies), ("kSteps", steps),
                        ("kMinBlocks", min_blocks)):
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text)
        assert n == 1, name
    path = OUT / f"c{copies}_s{steps}_b{min_blocks}" / SRC.name
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
        noise_texture_plain,
    )
    from hyper_ray_tracer_tpu_torch.render import init_state, trace
    from hyper_ray_tracer_tpu_torch.scene_tensors import to_device
    from hyper_ray_tracer_tpu_torch.utils import cuda_build

    nvcc = cuda_build.find_nvcc()

    def build(src):
        lib = src.parent / "libturbulence.so"
        proc = subprocess.run([nvcc, *cuda_build.NVCC_FLAGS, "-o", str(lib),
                               str(src)], capture_output=True, text=True,
                              timeout=600)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.parent.name}:\n{log}")
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", log)
        spill = re.search(r"(\d+) bytes spill stores", log).group(1)
        return (ctypes.CDLL(str(lib)),
                f"{m.group(1)} registers, {m.group(2)} B smem, {spill} B "
                f"spilled")

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
                    times.append(f"{label} "
                                 f"{device_ms(noise_texture, args, 20):.4f}"
                                 " ms")
                print(f"round {round_i} {src.parent.name} ({resources}): "
                      + ", ".join(times), flush=True)
    finally:
        cuda_build.load = load
    print(nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
