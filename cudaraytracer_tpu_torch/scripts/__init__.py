"""Measurement scripts for a machine with an NVIDIA GPU (``python -m
cudaraytracer_tpu_torch.scripts.<name>``); nothing here runs on import."""
