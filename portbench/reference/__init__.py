"""The benchmark's plain reference: float64 PyTorch and NumPy on the CPU,
written from the upstream definitions. Nothing here imports the program
under test, JAX or the JAX package; tests under ``portbench/tests`` hold
that."""
