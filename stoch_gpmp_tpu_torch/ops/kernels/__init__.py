"""Hand-written CUDA kernels for Hopper (sources in ``csrc/``), each with a
launch-counting wrapper and a plain PyTorch version in the same module.

- ``fields.raster_primitive_cost`` (K1): the raster collision field;
- ``fused_step.fused_planar_step`` (K2): the whole planar iteration;
- ``stencil.dof_quad_eval`` (K3): the dof-plane stencil energy;
- ``panda_fields.fk_link_fields_cost_rows`` (K4): FK + link fields;
- ``panda_step_dof.fused_panda_dof_step`` (K5): the whole dof Panda
  iteration;
- ``panda_step.fused_panda_step`` (K6): the whole flat Panda iteration;
- ``panda_fields.fused_link_fields_cost`` (K7): link fields at given link
  positions;
- ``panda_fields.fk_link_fields_cost`` (K8): FK + link fields per
  configuration;
- ``fused_step.fused_planar_step_per_particle`` (K9): the whole planar
  iteration with one seed pair per particle;
- ``fields.grid_lookup`` (K10): the occupancy-grid read;
- ``fields.primitive_field_cost`` (K11): the analytic rectangle and circle
  field;
- ``bidiag_scan.bidiag_scan`` (S1): the long-horizon sampler's
  block-bidiagonal plane solve;
- ``block_chol.block_chol`` (C1): the GP prior's block Cholesky factor and
  its dense inverse.

A wrapper launches its kernel for a CUDA tensor and runs the plain version
only for a CPU tensor; it never falls back from one to the other.
"""
