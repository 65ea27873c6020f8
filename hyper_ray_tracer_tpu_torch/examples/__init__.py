"""The fitting workflows of the JAX package's ``examples/inverse_*.py`` on
the port: ``python -m hyper_ray_tracer_tpu_torch.examples.inverse_geometry``
(and ``inverse_mirror``, ``inverse_glass``, ``inverse_rendering``), each
with its script's flags, defaults, printed lines and exit criterion, on
the card unless ``--cpu`` is passed."""
