"""Multi-GPU rendering and training through ``torch.distributed`` (the
JAX package's ``parallel/``): the (rays, spp) mesh of ranks
(``mesh.py``), deterministic reductions (``collectives.py``), the
sharded renderer, image assembly and the sharded train step
(``render_sharded.py``), and the scaling harness (``scaling.py``).
Launch one process per GPU, e.g. ``torchrun --nproc-per-node N``, and
call ``mesh.init_distributed`` in each."""
