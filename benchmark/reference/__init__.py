"""The benchmark's plain reference: a path tracer in plain PyTorch, the
training step it is differentiated in, and the intersection roofline. It
imports nothing of ``pathtracer_tpu_torch`` and nothing of JAX."""
