"""The benchmark of ``pathtracer_tpu_torch`` on NVIDIA GPUs.

``benchmark/run.py`` is the one command; ``BENCHMARK.json`` at the root of
the repository names its configurations, cells and metrics. The package
imports nothing of JAX or of the JAX package.
"""
