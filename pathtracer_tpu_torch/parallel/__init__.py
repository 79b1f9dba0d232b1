"""Sharding over a device mesh, collectives, and multi-process execution.

Port of ``pathtracer_tpu/parallel``. Submodules import lazily so that
``pathtracer_tpu_torch.parallel.distributed`` can be imported (and
``torch.distributed`` initialised) before anything else touches the card.
"""

_SUBMODULES = ("mesh", "render", "distributed", "launch")


def __getattr__(name):
    if name in _SUBMODULES:
        import importlib

        return importlib.import_module(f"pathtracer_tpu_torch.parallel.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_SUBMODULES))
