"""Benchmark of the PyTorch and CUDA port (``repro_torch``): the harness,
its traffic, configurations, per-layer readers and plain reference."""
