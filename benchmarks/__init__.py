"""The benchmark of the PyTorch/CUDA path tracer (``hyper_ray_tracer_tpu_torch``).

Run one cell of ``BENCHMARK.json`` from the root of a checkout, on a
machine with the cards the cell asks for::

    python3 -m benchmarks.run --workload render.final.cli --seed 1 \\
        --seconds 30 --trace 0

The harness is driven by data: everything that belongs to one
configuration, traffic mix, per-layer metric or cell lives in a file of
its own, found by the name ``BENCHMARK.json`` gives it:

* ``configs/<config>.json``: the scene, as run;
* ``traffic/<traffic>.json``: a traffic mix's parameters, among them
  ``generator``, the general generator that reads it
  (``generators/<generator>.py``: ``render``, ``fit``, ``sharded_render``);
* ``metrics/<metric>.py``: the reader of one per-layer metric, a
  ``read(trace)`` over the traced window's summary (``trace.py``); a
  metric split by cells (``idle_share.fit``) falls back to the reader of
  its name less the last ``.suffix`` (``idle_share.py``);
* ``limits/<cell>.json``: the numbers that decide a cell's ``correct``,
  each with its limit and the readings that set it;
* ``reference/``: the plain path tracer those numbers are taken against.
"""
