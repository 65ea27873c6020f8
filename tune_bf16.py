"""Tuning of K1b's bf16 form (``RenderSettings.bf16_hits``) on one GPU:
``python3 tune_bf16.py``.

Two parts, in one process:

* Instruction rates.  A probe kernel (written to ``build/tune_bf16/``)
  issues long runs of one instruction from every thread of a full SM,
  eight independent chains a thread, for the instructions the bf16 pair
  loop is made of: FFMA, FADD, the pack of float32 to bf16x2 (F2FP), a
  bf16x2 add and multiply, PRMT, LOP3, a funnel shift, MUFU's square
  root and the correctly rounded one.  Prints each as instructions per
  clock and SM, taking FFMA as 128 (the H100's 128 FP32 lanes an SM),
  and the clocks from one instruction to the next in one thread's
  dependent chain (its latency, loop overhead included); and checks on
  every non-negative bfloat16 value x that bf16(sqrt.approx(x)) equals
  bf16(sqrt.rn(x)).
* Launch shapes.  Builds copies of ``hyper_ray_tracer_tpu_torch/csrc``
  with other values of the bf16 form's constants (``kBf16Rays``, rays a
  thread; ``kBf16MinBlocks``, the resident-block floor that caps ptxas's
  registers; ``kBf16Pairs``, pairs of spheres a trip under one sign
  test) and three other designs: "pack", oc rounded two values by one
  F2FP and unpacked by two integer instructions (``oc_bf16``'s other
  body) in place of one F2FP a value; "unparked", the packet's float32
  terms left in registers through the loop (no ``hold``/``release``);
  "rn-root", the roots' correctly rounded square root in place of
  MUFU's.  Times each on `sphereflake`'s 1280x720 camera rays in sweep
  mode in two rounds, each output checked against
  ``typed_sweep_plain(..., bf16=True)`` bit for bit, and on as many rays
  whose lines meet no sphere (the pair loop without its roots).  Prints
  one line per build (registers, stack frame and spill bytes per
  kernel, from ``-Xptxas -v``) and one per variant and round.  The form
  ships the fastest variant without spills.

``--rates`` runs the first part alone.  ``--parent DIR`` (DIR a ``git
archive`` of an earlier commit under the ignored ``build/``) also times
that commit's bf16 form on the same rays, first and last in each round.
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
OUT = ROOT / "build" / "tune_bf16"
# (rays a thread, resident-block floor, pairs of spheres a trip, design:
# "shipped", "pack", "unparked" or "rn-root"); an SM has 65536
# registers, so the floor b caps a thread at 65536 / (128 * b).
VARIANTS = ((2, 6, 6, "shipped"), (2, 6, 5, "shipped"),
            (2, 6, 8, "shipped"), (2, 7, 4, "shipped"), (3, 4, 4, "shipped"),
            (4, 4, 4, "shipped"), (4, 4, 1, "shipped"), (2, 6, 6, "pack"),
            (2, 6, 6, "unparked"), (4, 4, 4, "unparked"),
            (2, 6, 6, "rn-root"))
CONSTANTS = ("kBf16Rays", "kBf16MinBlocks", "kBf16Pairs")
# oc_bf16's body when oc is packed two by one F2FP and unpacked.
OC_PACKED = ("  const unsigned w = pack_bf16(__fsub_rn(o, c0), "
             "__fsub_rn(o, c1));\n  v0 = lo_f32(w);\n  v1 = hi_f32(w);")

# The rate probe: OP(a, b) is one instruction on 32-bit words.
RATE_OPS = {
    "FFMA": 'asm volatile("fma.rn.f32 %0, %0, %1, %0;" : "+r"(a) : "r"(b));',
    "FADD": 'asm volatile("add.rn.f32 %0, %0, %1;" : "+r"(a) : "r"(b));',
    "F2FP pack of two": 'asm volatile("cvt.rn.bf16x2.f32 %0, %0, %1;" '
                        ': "+r"(a) : "r"(b));',
    "F2FP with zero": 'asm volatile("cvt.rn.bf16x2.f32 %0, %0, %1;" '
                      ': "+r"(a) : "r"(0u));',
    "bf16x2 add": 'asm volatile("add.rn.bf16x2 %0, %0, %1;" : "+r"(a) '
                  ': "r"(b));',
    "bf16x2 mul": 'asm volatile("mul.rn.bf16x2 %0, %0, %1;" : "+r"(a) '
                  ': "r"(b));',
    "PRMT": 'asm volatile("prmt.b32 %0, %0, %1, 0x7632;" : "+r"(a) '
            ': "r"(b));',
    "LOP3": 'asm volatile("lop3.b32 %0, %0, %1, 0x80008000, 0x80;" '
            ': "+r"(a) : "r"(b));',
    "funnel shift": 'asm volatile("shf.l.wrap.b32 %0, %0, %1, 16;" '
                    ': "+r"(a) : "r"(b));',
    "MUFU sqrt": 'asm volatile("sqrt.approx.f32 %0, %0;" : "+r"(a));',
    "sqrt.rn": 'asm volatile("sqrt.rn.f32 %0, %0;" : "+r"(a));',
}
RATE_ITERS = 4096


def rate_source():
    """The probe's CUDA source: one kernel per RATE_OPS entry, a launcher
    by index, and the square-root check."""
    kernels = []
    for i, body in enumerate(RATE_OPS.values()):
        kernels.append(f"""
__global__ void __launch_bounds__(256) rate{i}(unsigned* out, unsigned seed) {{
  unsigned x[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    x[k] = __float_as_uint(1.0f + 1e-3f * (threadIdx.x + k)) ^ seed;
  for (int it = 0; it < {RATE_ITERS}; ++it) {{
#pragma unroll
    for (int k = 0; k < 8; ++k) {{
      unsigned a = x[k];
      const unsigned b = x[(k + 1) & 7];
      {body}
      x[k] = a;
    }}
  }}
  unsigned s = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) s ^= x[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}}""")
    for i, body in enumerate(RATE_OPS.values()):
        kernels.append(f"""
__global__ void lat{i}(unsigned* out, long long* cycles, unsigned seed) {{
  unsigned a = __float_as_uint(1.0f) ^ seed;
  const unsigned b = __float_as_uint(1.0f + 1e-3f) ^ seed;
  const long long t0 = clock64();
  for (int it = 0; it < {RATE_ITERS // 16}; ++it) {{
#pragma unroll
    for (int k = 0; k < 16; ++k) {{
      {body}
    }}
  }}
  const long long t1 = clock64();
  out[0] = a;
  cycles[0] = t1 - t0;
}}""")
    cases = "\n".join(
        f"    case {i}: rate{i}<<<blocks, 256, 0, s>>>(out, 0u); break;"
        for i in range(len(RATE_OPS)))
    lat_cases = "\n".join(
        f"    case {i}: lat{i}<<<1, 1, 0, s>>>(out, cycles, 0u); break;"
        for i in range(len(RATE_OPS)))
    return "\n".join(kernels) + f"""

extern "C" int launch_rate(int i, unsigned* out, int blocks, void* stream) {{
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (i) {{
{cases}
    default: return -1;
  }}
  return static_cast<int>(cudaGetLastError());
}}

// One thread's chain of dependent instructions: clocks in cycles[0].
extern "C" int launch_latency(int i, unsigned* out, long long* cycles,
                              void* stream) {{
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (i) {{
{lat_cases}
    default: return -1;
  }}
  return static_cast<int>(cudaGetLastError());
}}

// bf16(sqrt.approx(x)) against bf16(sqrt.rn(x)) for every non-negative
// bfloat16 x (the word's high half, its low half zero): mismatches counted.
__device__ __forceinline__ unsigned bf16_of(float x) {{
  unsigned u;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(u) : "f"(x), "f"(0.0f));
  return u;
}}

__global__ void sqrt_check(unsigned* mismatches) {{
  const unsigned h = blockIdx.x * blockDim.x + threadIdx.x;
  if (h >= 0x8000u) return;
  const float x = __uint_as_float(h << 16);
  float a, r;
  asm("sqrt.approx.f32 %0, %1;" : "=f"(a) : "f"(x));
  asm("sqrt.rn.f32 %0, %1;" : "=f"(r) : "f"(x));
  if (bf16_of(a) != bf16_of(r)) atomicAdd(mismatches, 1u);
}}

extern "C" int launch_sqrt_check(unsigned* mismatches, void* stream) {{
  sqrt_check<<<128, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      mismatches);
  return static_cast<int>(cudaGetLastError());
}}
"""


def rates(nvcc, flags):
    """Part 1: each RATE_OPS instruction's rate an SM and clock, FFMA
    taken as 128, and the square-root check."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "rates.cu"
    src.write_text(rate_source())
    lib = OUT / "librates.so"
    proc = subprocess.run([nvcc, *flags, "-o", str(lib), str(src)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on rates.cu:\n{proc.stdout}"
                           f"{proc.stderr}")
    cuobjdump = Path(nvcc).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    so = ctypes.CDLL(str(lib))
    vp = ctypes.c_void_p
    so.launch_rate.argtypes = [ctypes.c_int, vp, ctypes.c_int, vp]
    so.launch_sqrt_check.argtypes = [vp, vp]
    so.launch_latency.argtypes = [ctypes.c_int, vp, vp, vp]
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream(dev).cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = sms * 8  # 64 warps an SM
    out = torch.empty(blocks * 256, dtype=torch.int32, device=dev)

    def ms(i, reps=5):
        assert so.launch_rate(i, out.data_ptr(), blocks, stream) == 0
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            so.launch_rate(i, out.data_ptr(), blocks, stream)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    times = {name: ms(i) for i, name in enumerate(RATE_OPS)}
    per_sm = blocks * 256 * RATE_ITERS * 8 / sms  # instructions an SM
    clocks = per_sm / 128 / (times["FFMA"] * 1e-3)  # FFMA at 128 a clock
    lines = []
    for i, (name, t) in enumerate(times.items()):
        func = next(f for f in sass.split("Function : ")[1:]
                    if re.search(rf"\drate{i}P", f.splitlines()[0]))
        ops = sorted(set(re.findall(r"\s([A-Z][A-Z0-9_.]+)\s+R",
                                    func)) - {"MOV", "IMAD.MOV.U32"})
        cycles = torch.zeros(1, dtype=torch.int64, device=dev)
        assert so.launch_latency(i, out.data_ptr(), cycles.data_ptr(),
                                 stream) == 0
        torch.cuda.synchronize()
        lat = int(cycles.item()) / RATE_ITERS
        lines.append(f"{name}: {t:.4f} ms, {per_sm / (t * 1e-3) / clocks:.1f}"
                     f" a clock and SM, {lat:.1f} cycles dependent "
                     f"({', '.join(ops)})")
    bad = torch.zeros(1, dtype=torch.int32, device=dev)
    assert so.launch_sqrt_check(bad.data_ptr(), stream) == 0
    torch.cuda.synchronize()
    lines.append(f"sqrt.approx vs sqrt.rn after rounding to bf16: "
                 f"{int(bad.item())} of 32768 non-negative bf16 values "
                 f"differ; FFMA clock {clocks / 1e9:.3f} GHz")
    return lines


def variant_sources(rays, min_blocks, pairs, design):
    """A copy of csrc/ with the bf16 form's three constants replaced and
    the ``design`` (VARIANTS) applied."""
    d = OUT / f"r{rays}_b{min_blocks}_p{pairs}_{design}"
    d.mkdir(parents=True, exist_ok=True)
    for f in SRC.iterdir():
        text = f.read_text()
        if f.name == "typed_sweep.cu":
            for name, value in zip(CONSTANTS, (rays, min_blocks, pairs)):
                text, n = re.subn(rf"constexpr int {name} = \d+;",
                                  f"constexpr int {name} = {value};", text)
                assert n == 1, name
            if design == "pack":
                text, n = re.subn(
                    r"(float& v1\) \{\n)  v0 = round_bf16\(.*?\n.*?;\n",
                    lambda m: m.group(1) + OC_PACKED + "\n", text)
                assert n == 1, "oc_bf16"
            if design == "rn-root":
                text, n = re.subn(r'asm\("sqrt\.approx\.f32 %0, %1;" : '
                                  r'"=f"\(r\) : "f"\(x\)\);',
                                  "r = __fsqrt_rn(x);", text)
                assert n == 1, "sqrt_of_bf16"
            if design == "unparked":
                text, n = re.subn(r"\n  (hold|release)<R>\(pk\);", "", text)
                assert n == 2, "hold/release"
        (d / f.name).write_text(text)
    return d


def shapes(nvcc, flags, parent=None):
    """Part 2: the launch shapes, each checked and timed; ``parent``: a
    checkout whose bf16 form (which took its radii as a [P] float32
    array of bf16(bf16(r)^2)) is timed beside them."""
    from hyper_ray_tracer_tpu_torch import build_scene
    from hyper_ray_tracer_tpu_torch.camera import make_basis
    from hyper_ray_tracer_tpu_torch.ops import rng as prng
    from hyper_ray_tracer_tpu_torch.ops import typed_sweep as k1b
    from hyper_ray_tracer_tpu_torch.render import T_MIN, init_state
    from hyper_ray_tracer_tpu_torch.scene_tensors import to_device
    from hyper_ray_tracer_tpu_torch.utils import cuda_build

    def build(d):
        lib = d / "libtyped_sweep.so"
        proc = subprocess.run([nvcc, *flags, "-Xptxas", "-v", "-o", str(lib),
                               str(d / "typed_sweep.cu")],
                              capture_output=True, text=True, timeout=600)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {d.name}:\n{log}")
        return lib, list(zip(re.findall(r"Used (\d+) registers", log),
                             re.findall(r"(\d+) bytes stack frame", log),
                             re.findall(r"(\d+) bytes spill stores", log)))

    dirs = [variant_sources(*v) for v in VARIANTS]
    if parent is not None:
        dirs.append(Path(parent).resolve() / "hyper_ray_tracer_tpu_torch"
                    / "csrc")
    with ThreadPoolExecutor(len(dirs)) as pool:
        built = list(pool.map(build, dirs))
    libs = {}
    for d, (lib, regs) in zip(dirs, built):
        name = "parent" if parent is not None and d == dirs[-1] else d.name
        print(f"{name}: (registers, stack frame bytes, spill bytes) per "
              f"kernel {regs}", flush=True)
        libs[name] = k1b._bind(ctypes.CDLL(str(lib)))

    dev = torch.device("cuda")
    W, H = 1280, 720
    scene = build_scene("sphereflake")
    st = to_device(scene.arrays, scene.static, dev)
    pix = torch.arange(W * H, device=dev)
    s = init_state(make_basis(scene.camera, W, H), W, H, pix,
                   torch.zeros_like(pix), 0)
    args = (st.sweep, s.o.contiguous(), s.d.contiguous(),
            s.time.contiguous(), s.alive.contiguous(),
            prng.bounce_base(s.base, 0).contiguous())
    want = k1b.typed_sweep_plain(*args, T_MIN, bf16=True)

    sw, n = args[0], args[1].shape[0]
    rr16 = sw.geo16[:, 3].contiguous()
    # The same count of rays on lines that pass 10,000 units from the
    # scene: no bf16 discriminant is >= 0, so the roots never run.
    far = torch.zeros_like(args[1])
    far[:, 1] = 1.0e4
    far[:, 2] = torch.linspace(-1.0, 1.0, n, device=dev)
    away = torch.zeros_like(args[2])
    away[:, 0] = 1.0
    misses = (sw, far, away, *args[3:])
    assert (k1b.typed_sweep_plain(*misses, T_MIN, bf16=True)[1] == -1).all()

    def launch(name, rays=args):
        """One launch of variant ``name``'s bf16 form on ``rays``."""
        t_best = torch.empty(n, dtype=torch.float32, device=dev)
        best = torch.empty(n, dtype=torch.int32, device=dev)
        o, d, time_, active, bits = rays[1:]
        records = rr16 if name == "parent" else sw.geo16
        cuda_build.launch(
            "typed_sweep", libs[name], dev, o.data_ptr(), d.data_ptr(),
            time_.data_ptr(), active.data_ptr(), bits.data_ptr(), n,
            sw.geo.data_ptr(), sw.aux.data_ptr(), sw.xf.data_ptr(),
            sw.plan_rows.data_ptr(), len(sw.plan), sw.geo.shape[0],
            sw.shutter.data_ptr(), 0, T_MIN, None, 0, 0, 0, 0, 0,
            records.data_ptr(), t_best.data_ptr(), best.data_ptr(),
            tag="K1b", lanes=n)
        return t_best, best

    def time_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    order = list(libs)
    if parent is not None:  # first and last in each round
        order = ["parent"] + order[:-1] + ["parent"]
    assert not any(t.xform for t in sw.plan)
    for round_i in range(2):
        f32 = time_ms(lambda: k1b.typed_sweep(*args))
        for name in order:
            if round_i == 0:
                got = launch(name)
                assert all(torch.equal(x, y) for x, y in
                           zip(got, want)), name
            ms = time_ms(lambda: launch(name))
            no_roots = time_ms(lambda: launch(name, misses))
            print(f"round {round_i} {name}: sphereflake camera rays K1b "
                  f"bf16 {ms:.4f} ms (K1b float32 {f32:.4f} ms); on "
                  f"lines that meet no sphere {no_roots:.4f} ms",
                  flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("tune_bf16: no CUDA device is available", file=sys.stderr)
        return 1
    from hyper_ray_tracer_tpu_torch.utils import cuda_build

    nvcc = cuda_build.find_nvcc()
    flags = [f for f in cuda_build.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    for line in rates(nvcc, flags):
        print(line, flush=True)
    argv = sys.argv[1:]
    if "--rates" not in argv:
        shapes(nvcc, flags, argv[argv.index("--parent") + 1]
               if "--parent" in argv else None)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
