"""Sharded render traffic: ``render`` traffic on a (ranks, 1) rays mesh
through ``parallel/render_sharded.make_sharded_renderer``.

Traffic parameters: those of ``render`` (``generators/render.py``) and
``ranks``.  The run's own process is rank 0; it spawns the other ranks,
which rendezvous with it through a file under ``TMPDIR`` (NCCL on the
cards, gloo on the CPU), and drives them: before every call rank 0
broadcasts what to do (warm up, render image i, start or stop tracing,
stop), every rank renders its shard of image i, and the sums are
gathered on every rank.  Each rank builds and uploads the scene once, in
set-up.  Rank 0 keeps each image; the check is the render generator's.
"""

from __future__ import annotations

import os
import tempfile

import torch

from benchmarks import faults
from benchmarks.generators import render as single

STOP, IMAGE, TRACE_ON, TRACE_OFF, WARM = 0, 1, 2, 3, 4


class Worker:
    """One rank's program objects."""

    def __init__(self, config, traffic, seed, rank, world, device, fault):
        from hyper_ray_tracer_tpu_torch import build_scene
        from hyper_ray_tracer_tpu_torch.camera import make_basis
        from hyper_ray_tracer_tpu_torch.parallel.mesh import make_render_mesh
        from hyper_ray_tracer_tpu_torch.parallel.render_sharded import (
            make_sharded_renderer)
        from hyper_ray_tracer_tpu_torch.render import (RenderSettings,
                                                       prepare_scene,
                                                       spp_per_chunk)
        from hyper_ray_tracer_tpu_torch.scene_tensors import to_device

        t = traffic
        self.device, self.rank, self.seed = device, rank, seed
        self.W, self.H = int(t["width"]), int(t["height"])
        self.spp, self.depth = int(t["samples"]), int(t["depth"])
        self.stride = int(t.get("seed_stride", 1000))
        self.fault = fault
        self.scene = build_scene(config["scene"])
        arrays, structure, mode = prepare_scene(
            self.scene, t.get("intersector", "auto"),
            int(t.get("leaf_size", 4)))
        self.scene_t = to_device(arrays, self.scene.static, device, structure)
        self.basis = make_basis(self.scene.camera, self.W, self.H)
        mesh = make_render_mesh(world, 1)
        self.run = make_sharded_renderer(
            self.scene, self.W, self.H, self.depth, mesh, mode,
            int(t.get("leaf_size", 4)), bool(t.get("partition", True)))
        self.chunk = spp_per_chunk(RenderSettings(self.W, self.H, self.spp,
                                                  self.depth))
        self.prof = None

    def image(self, i, samples=None):
        seed = single.image_seed(self.seed, self.stride, i)
        with faults.sharded_fault(self.fault):
            acc = self.run(self.scene_t, self.basis, 0, samples or self.spp,
                           seed)
        return acc, seed

    def do(self, op, arg):
        """One command; returns what rank 0 keeps."""
        if op == WARM:
            acc, _ = self.image(0, self.chunk)
            _sync(self.device)
            return None
        if op == IMAGE:
            acc, seed = self.image(arg)
            if self.rank:
                _sync(self.device)
                return None
            return acc.cpu().numpy(), seed  # waits for the device
        if op == TRACE_ON:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            return None
        if op == TRACE_OFF:
            from benchmarks.trace import summarize
            self.prof.__exit__(None, None, None)
            summary = summarize(self.prof.events(), {"images": arg})
            self.prof = None
            return summary
        raise ValueError(op)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _command(device, op=0, arg=0):
    import torch.distributed as dist
    t = torch.tensor([op, arg], dtype=torch.int64, device=device)
    dist.broadcast(t, 0)
    return int(t[0]), int(t[1])


def _peak(device):
    if device.type != "cuda":
        return 0
    return int(torch.cuda.max_memory_allocated(device))


def rank_main(rank, world, init_file, config, traffic, seed, cpu, fault):
    """A spawned rank: join the group, build, and serve rank 0's
    commands until told to stop."""
    import torch.distributed as dist

    from hyper_ray_tracer_tpu_torch.parallel.mesh import init_distributed

    device = torch.device("cpu") if cpu else torch.device("cuda", rank)
    init_distributed(device=device, init_method=f"file://{init_file}",
                     rank=rank, world_size=world)
    try:
        w = Worker(config, traffic, seed, rank, world, device, fault)
        while True:
            op, arg = _command(device)
            if op == STOP:
                dist.gather_object(_peak(device), None, dst=0)
                break
            out = w.do(op, arg)
            if op == TRACE_OFF:
                dist.gather_object(out, None, dst=0)
    finally:
        dist.destroy_process_group()


class Session(single.Session):
    def __init__(self, ctx):
        import multiprocessing

        import torch.distributed as dist

        from hyper_ray_tracer_tpu_torch.parallel.mesh import init_distributed

        self.ctx = ctx
        tr = ctx["traffic"]
        self.world = int(tr["ranks"])
        cpu = ctx["device"].type == "cpu"
        self.device = ctx["device"]
        fd, self.init_file = tempfile.mkstemp(prefix="hrt_rendezvous_")
        os.close(fd)
        os.unlink(self.init_file)
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        mp = multiprocessing.get_context("spawn")
        self.procs = [mp.Process(target=rank_main, args=(
            r, self.world, self.init_file, ctx["config"], tr, ctx["seed"],
            cpu, ctx["fault"])) for r in range(1, self.world)]
        for p in self.procs:
            p.start()
        init_distributed(device=self.device,
                         init_method=f"file://{self.init_file}", rank=0,
                         world_size=self.world)
        self.dist = dist
        self.worker = Worker(ctx["config"], tr, ctx["seed"], 0, self.world,
                             self.device, ctx["fault"])
        self.scene = self.worker.scene
        self.W, self.H = self.worker.W, self.worker.H
        self.spp, self.depth = self.worker.spp, self.worker.depth
        self.control = None
        self.images, self.seeds = [], []
        self.peaks = []

    def _all(self, op, arg=0):
        _command(self.device, op, arg)
        return self.worker.do(op, arg)

    def warm(self):
        self._all(WARM)

    def run(self, i):
        acc, seed = self._all(IMAGE, i)
        from hyper_ray_tracer_tpu_torch.parallel.render_sharded import (
            finish_image)
        self.images.append(finish_image(acc, self.spp, self.W, self.H))
        self.seeds.append(seed)
        return self.W * self.H * self.spp

    def traced(self, loop):
        from benchmarks.trace import merge
        self._all(TRACE_ON)
        records = loop()
        n = len(records)
        mine = self._all(TRACE_OFF, n)
        parts = [None] * self.world
        self.dist.gather_object(mine, parts, dst=0)
        window = records[-1][1] - records[0][0]
        for p in parts:
            p["work"] = {"images": n,
                         "camera_rays": sum(w for _, _, w in records)}
        return merge(parts), window

    def end_to_end(self, records, window_s):
        rays = sum(w for _, _, w in records)
        return {"sharded_render_mrays_s": rays / window_s / 1e6}

    def device_info(self):
        return dict(single.device_info(self.device, self.world),
                    memory_peak_bytes=max(self.peaks or [_peak(self.device)]))

    def free(self):
        if self.procs:
            _command(self.device, STOP)
            peaks = [None] * self.world
            self.dist.gather_object(_peak(self.device), peaks, dst=0)
            self.peaks = peaks
            for p in self.procs:
                p.join(timeout=120)
            alive = [p for p in self.procs if p.is_alive()]
            for p in alive:
                p.terminate()
                p.join(timeout=30)
            self.dist.destroy_process_group()
            self.procs = []
            if os.path.exists(self.init_file):
                os.unlink(self.init_file)
            if alive:
                raise RuntimeError(f"{len(alive)} rank(s) did not stop")
        self.worker = None
        super().free()
