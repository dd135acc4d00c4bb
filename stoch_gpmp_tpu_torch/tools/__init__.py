"""Measurement tools of the port that need one NVIDIA GPU (run as modules)."""
