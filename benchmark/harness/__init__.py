"""The benchmark's harness: it resolves a cell of ``BENCHMARK.json`` by
name, drives the cell's traffic through raytracer_tpu_torch's entry points
in a closed loop with one client, reads the per-layer metrics from spans
and the device trace, and decides ``correct`` by the plain reference in
``benchmark/reference/``. Nothing here imports ``jax``, ``jaxlib``,
``flax`` or ``raytracer_tpu``."""
