"""The material gathers' backward wrapper (``ops.gather.segment_sum``) and
its place among the kernels on the CPU: CPU tensors take the plain version
(a zero table and ``_index_put_impl_``, autograd's own backward of
``table[ids]``) and launch nothing; the wrapper refuses on the host, before
any build, what the kernel cannot take; ``kernels`` counts the new family and
declares every C entry point's pointers as pointers."""

import ctypes
import glob
import os
import re

import pytest
import torch

from pathtracer_tpu_torch import kernels
from pathtracer_tpu_torch.ops import gather
from pathtracer_tpu_torch.ops.gather import gather_rows, segment_sum


@pytest.fixture
def one_thread():
    """The CPU's index backward sums in a fixed order only on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("shape", [(5, 3), (5,)], ids=["rows", "column"])
def test_segment_sum_on_cpu_is_the_plain_version(one_thread, monkeypatch, shape):
    monkeypatch.setitem(gather.launches, "sum", 0)
    g = torch.Generator().manual_seed(4)
    ids = torch.randint(0, shape[0], (50_000,), generator=g)
    grad = torch.rand((ids.shape[0], *shape[1:]), generator=g)
    want = torch.zeros(shape).index_put_((ids,), grad, accumulate=True)
    assert torch.equal(segment_sum(grad, ids, shape), want)
    table = torch.rand(shape, generator=g, requires_grad=True)
    (gather_rows(table, ids) * grad).sum().backward()
    assert torch.equal(table.grad, want)
    assert gather.launches == {"sum": 0}


@pytest.mark.parametrize("bad", ["grad_f64", "ids_float", "ids_2d", "grad_rank", "table_rank"])
def test_segment_sum_refuses_off_the_cpu_before_any_build(monkeypatch, bad):
    """Tensors off the CPU (here ``meta``: shapes and types, no data) take
    the kernel's path, whose checks raise before the library is built."""
    monkeypatch.setattr(kernels, "library", lambda: pytest.fail("built the library"))
    grad = torch.zeros(8, 3, device="meta")
    ids = torch.zeros(8, dtype=torch.int64, device="meta")
    shape = (5, 3)
    if bad == "grad_f64":
        grad = grad.double()
    elif bad == "ids_float":
        ids = ids.float()
    elif bad == "ids_2d":
        ids = ids.view(2, 4)
    elif bad == "grad_rank":
        grad = grad[:, :, None]
    else:
        grad, shape = grad[:, :, None], (5, 3, 1)
    with pytest.raises(TypeError if bad in ("grad_f64", "ids_float") else ValueError):
        segment_sum(grad, ids, shape)


def test_launch_counts_include_the_gather_backward(monkeypatch):
    monkeypatch.setitem(gather.launches, "sum", 3)
    counts = kernels.launch_counts()
    assert counts["gather_backward"] is gather.launches
    assert set(counts) == {"small", "shortlist", "tiled", "cluster", "gather_backward", "bounce"}
    saved = {f: dict(c) for f, c in counts.items()}
    try:
        kernels.reset_launches()
        assert gather.launches == {"sum": 0}
        assert not any(v for c in kernels.launch_counts().values() for v in c.values())
    finally:
        for f, c in counts.items():
            c.update(saved[f])


def _c_parameters(name):
    """The parameters of the C entry point ``name`` as csrc defines it."""
    for path in glob.glob(os.path.join(kernels.CSRC, "*.cu")):
        with open(path) as f:
            found = re.search(r"\n\w[\w\s\*]*\b" + name + r"\(([^)]*)\)\s*\{", f.read())
        if found:
            return [p.strip() for p in found.group(1).split(",") if p.strip()]
    raise AssertionError(f"{name} is defined in no csrc/*.cu")


@pytest.mark.parametrize("name", sorted(kernels._SIGNATURES))
def test_ctypes_signatures_declare_every_pointer_as_a_pointer(name):
    """ctypes passes an argument it has no type for as a 32-bit int, which
    cuts a pointer: every pointer parameter of each C entry point, the
    stream included, is ``c_void_p``, and every ``int`` is ``c_int``."""
    argtypes, _ = kernels._SIGNATURES[name]
    params = _c_parameters(name)
    assert len(params) == len(argtypes), (name, params)
    for param, argtype in zip(params, argtypes):
        if "*" in param:
            assert argtype is ctypes.c_void_p, (name, param)
        else:
            assert param.split()[0] == "int" and argtype is ctypes.c_int, (name, param)
