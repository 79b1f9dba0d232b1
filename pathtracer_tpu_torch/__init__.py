"""pathtracer_tpu_torch — the path tracer in PyTorch, with CUDA kernels.

A port of ``pathtracer_tpu`` (JAX, Pallas kernels for the TPU) to PyTorch on
an NVIDIA GPU. The JAX package stays the reference; this package imports
``torch`` and never ``jax`` or ``flax``.

- ``models`` — host frontend: INI configs, XML scene graphs, OBJ/MTL meshes,
  materials, BVH build, SoA packing (numpy), and the torch ``Scene``.
- ``ops``    — device compute on torch tensors: camera rays, intersection,
  BSDFs, light sampling, the integrator, the regenerative pool, tonemaps.
- ``kernels`` — builds the hand-written CUDA kernels in ``csrc/`` with nvcc
  at first use and loads them with ctypes.
- ``render``, ``cli`` — the rendering API and the command-line renderer.
"""

__version__ = "0.1.0"
