"""The (rays, spp) mesh of ranks and the process group under it.

The JAX package shards a render over a ``jax.sharding.Mesh`` of devices
(its ``parallel/mesh.py``); the port runs one process per GPU under
``torch.distributed``, and a mesh is a map of those processes' ranks:

* axis ``rays``: data parallelism over the pixels of the sample-major
  launch (the analogue of the reference's image tiles);
* axis ``spp``: sample parallelism: ranks render disjoint sample ranges
  of the same pixels, and their radiance sums are folded together.

Ranks are laid out as the JAX package lays devices out,
``devices.reshape(n_rays, n_spp)``: mesh rank ``r`` holds rays shard
``r // n_spp`` and spp shard ``r % n_spp``.  The scene, its parameters and
the camera are small and replicated on every rank.

``init_distributed`` starts the process group from a launcher's
environment (``torchrun``) or from explicit arguments.  It picks the
backend from the device, ``nccl`` for CUDA and ``gloo`` for the CPU, and
falls back from nothing: a machine without CUDA gets an error unless the
caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

@dataclasses.dataclass(frozen=True)
class RenderMesh:
    """``n_rays`` x ``n_spp`` ranks, the world's first: mesh rank r is
    world rank r.  ``group``: the process group of all of them (None for
    a mesh with no process group, which tests use to lay out shards in
    one process); ``spp_groups[i]``: the ranks of rays shard i (they fold
    their sums), ``rays_groups[j]``: the ranks of spp shard j (they
    gather the pixels); empty where an axis has one rank, since nothing
    is reduced over it."""

    n_rays: int
    n_spp: int = 1
    group: Optional[object] = None
    spp_groups: Tuple[object, ...] = ()
    rays_groups: Tuple[object, ...] = ()

    @property
    def size(self) -> int:
        return self.n_rays * self.n_spp

    def coords(self, rank: int) -> Tuple[int, int]:
        """(rays shard, spp shard) of mesh rank ``rank``."""
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} is outside the "
                             f"{self.n_rays}x{self.n_spp} mesh")
        return divmod(rank, self.n_spp)

    @property
    def rank(self) -> Optional[int]:
        """This process's mesh rank, or None when it is not in the mesh."""
        if self.group is None or not dist.is_initialized():
            return None
        me = dist.get_rank()
        return me if me < self.size else None

    def spp_group(self, rank: int):
        """The group that folds ``rank``'s sums over the spp axis."""
        return self.spp_groups[self.coords(rank)[0]] if self.spp_groups \
            else None

    def rays_group(self, rank: int):
        """The group that gathers ``rank``'s pixels over the rays axis."""
        return self.rays_groups[self.coords(rank)[1]] if self.rays_groups \
            else None


def make_render_mesh(n_rays_shards: Optional[int] = None,
                     n_spp_shards: int = 1) -> RenderMesh:
    """A (rays, spp) mesh over the first ``n_rays_shards * n_spp_shards``
    ranks of the world; ``n_rays_shards`` defaults to all of them over
    ``n_spp_shards``.  A collective: every rank calls it with the same
    arguments, since each subgroup is made by all of them
    (``torch.distributed.new_group``).  Raises ``ValueError`` when the
    mesh needs more ranks than the world has."""
    if not dist.is_initialized():
        raise RuntimeError("make_render_mesh: no process group; call "
                           "init_distributed first")
    world = dist.get_world_size()
    if n_rays_shards is None:
        n_rays_shards = world // n_spp_shards
    n = n_rays_shards * n_spp_shards
    if n > world or n < 1:
        raise ValueError(
            f"mesh {n_rays_shards}x{n_spp_shards} needs {n} ranks, "
            f"have {world}")
    mesh_group = dist.group.WORLD if n == world \
        else dist.new_group(list(range(n)))
    spp_groups = rays_groups = ()
    if n_spp_shards > 1:
        spp_groups = tuple(
            dist.new_group([i * n_spp_shards + j
                            for j in range(n_spp_shards)])
            for i in range(n_rays_shards))
    if n_rays_shards > 1:
        rays_groups = tuple(
            dist.new_group([i * n_spp_shards + j
                            for i in range(n_rays_shards)])
            for j in range(n_spp_shards))
    return RenderMesh(n_rays_shards, n_spp_shards, mesh_group, spp_groups,
                      rays_groups)


def init_distributed(device=None, backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None):
    """Start the process group (once) and return (rank, world size,
    device).

    ``rank`` / ``world_size`` default to the launcher's ``RANK`` /
    ``WORLD_SIZE`` (``torchrun``), and ``init_method`` to ``env://``
    (``MASTER_ADDR`` / ``MASTER_PORT``); a process with neither is a group
    of one.  ``device`` defaults to ``cuda:LOCAL_RANK`` (so does a CUDA
    device without an index); a machine without CUDA raises unless
    ``device`` is the CPU.  ``backend`` defaults to
    ``nccl`` for a CUDA device and ``gloo`` for the CPU; ``gloo`` with CUDA
    tensors is for several ranks on one card, which NCCL refuses.
    Nothing falls back: a backend or device that fails raises."""
    env = os.environ
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed: no CUDA device is "
                               "available; pass device='cpu' to run on the "
                               "CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(env.get("LOCAL_RANK", 0)))
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("init_distributed: nccl needs a CUDA device")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), device
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world_size = (int(env.get("WORLD_SIZE", 1)) if world_size is None
                  else world_size)
    if init_method is None and world_size == 1 \
            and "MASTER_ADDR" not in env:
        # A group of one needs no rendezvous: an in-memory store.
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    else:
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world_size)
    return rank, world_size, device
