"""Hand-written CUDA kernels for Hopper (sources in ``csrc/``), each with a
launch-counting wrapper and a plain PyTorch version in the same module.

- ``fields.raster_primitive_cost``: the raster collision field;
- ``fused_step.fused_planar_step``: the whole planar iteration.

A wrapper launches its kernel for a CUDA tensor and runs the plain version
only for a CPU tensor; it never falls back from one to the other.
"""
