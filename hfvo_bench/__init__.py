"""Benchmark of the PyTorch and CUDA port `hfvo_tpu_torch` (see run.py)."""
