"""Card tests of the material gathers' backward kernel
(``ops.gather.segment_sum``, ``csrc/gather_backward.cu``). They need a CUDA
device and skip without one:

    PT_TPU_TEST_REAL_DEVICE=1 python -m pytest tests/test_torch_gather_card.py -m gpu

The reference is the same sum in float64 (``index_add_``), cast to float32.
The kernel sums in float32 in another order than autograd's backward, so an
element may differ from it by a few float32 roundings of its partial sums:
the tolerance is SUM_RTOL of the element's sum of |terms| (about 85 float32
ulps of it; a sum through the kernel's tree rounds at most about 30 times).
An element that no row adds to is +0.0 exactly. Two calls give the same bits.
"""

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.ops import gather
from pathtracer_tpu_torch.ops.gather import segment_sum

pytestmark = pytest.mark.gpu

SUM_RTOL = 1e-5
FULL = 262_144  # the lanes of a 512^2 wave


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _ids(pattern, m, b, g):
    if pattern == "uniform":
        ids = g.integers(0, m, b)
    elif pattern == "one_id":
        ids = np.full(b, m - 1)
    elif pattern == "only_0":
        ids = np.zeros(b, dtype=np.int64)
    else:  # "sparse": every 97th row of the table, so most rows get nothing
        ids = g.integers(0, -(-m // 97), b) * 97
    return ids


def _inputs(dev, m, k, b, pattern, seed=0):
    g = np.random.default_rng(seed)
    shape = (m,) if k == 1 else (m, k)
    grad = torch.as_tensor(g.normal(size=(b, *shape[1:])), dtype=torch.float32, device=dev)
    ids = torch.as_tensor(_ids(pattern, m, b, g), dtype=torch.int64, device=dev)
    return grad, ids, shape


def _assert_sums(got, grad, ids, shape):
    """``got`` against the float64 sum, within SUM_RTOL of each element's
    sum of |terms|; +0.0 exactly where nothing was added."""
    zero = torch.zeros(shape, dtype=torch.float64, device=grad.device)
    want = zero.index_add(0, ids, grad.double())
    mass = zero.index_add(0, ids, grad.abs().double())
    assert got.shape == want.shape and got.dtype == torch.float32
    assert ((got.double() - want).abs() <= SUM_RTOL * mass).all()
    empty = mass == 0
    assert (got[empty] == 0).all() and not torch.signbit(got[empty]).any()


@pytest.mark.parametrize("pattern", ["uniform", "one_id", "only_0", "sparse"])
@pytest.mark.parametrize("b", [0, 1, 31, FULL])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("m", [1, 5, 64, 4096])
def test_segment_sum_equals_float64_sum(cuda, m, k, b, pattern):
    grad, ids, shape = _inputs(cuda, m, k, b, pattern)
    before = gather.launches["sum"]
    got = segment_sum(grad, ids, shape)
    again = segment_sum(grad, ids, shape)
    assert gather.launches["sum"] == before + 2
    torch.cuda.synchronize()
    _assert_sums(got, grad, ids, shape)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


def test_segment_sum_takes_int32_and_negative_ids(cuda):
    """int32 ids give the int64 result; a negative id counts from the end,
    as indexing does."""
    grad, ids, shape = _inputs(cuda, 5, 3, FULL, "uniform", seed=1)
    got = segment_sum(grad, ids, shape)
    assert torch.equal(segment_sum(grad, ids.int(), shape), got)
    assert torch.equal(segment_sum(grad, torch.where(ids % 2 == 1, ids - 5, ids), shape), got)


@pytest.mark.parametrize("layout", ["strided", "expanded", "transposed"])
def test_segment_sum_takes_non_contiguous_grad(cuda, layout):
    g = torch.Generator(cuda).manual_seed(2)
    ids = torch.randint(0, 5, (FULL,), device=cuda, generator=g)
    if layout == "strided":
        grad = torch.randn(FULL, 6, device=cuda, generator=g)[:, ::2]
    elif layout == "expanded":  # as autograd may hand a gradient of ones
        grad = torch.ones(1, 3, device=cuda).expand(FULL, 3)
    else:
        grad = torch.randn(3, FULL, device=cuda, generator=g).t()
    assert not grad.is_contiguous()
    got = segment_sum(grad, ids, (5, 3))
    assert torch.equal(got, segment_sum(grad.contiguous(), ids, (5, 3)))
    _assert_sums(got, grad, ids, (5, 3))


def test_segment_sum_bits_repeat_on_the_fit_shape(cuda):
    """The fit's gathers, [262,144, 3] and [262,144] rows into the Cornell
    box's five materials with miss lanes on row 0: the same bits in five
    calls, and through ``gather_rows``'s backward."""
    g = torch.Generator(cuda).manual_seed(3)
    ids = torch.randint(1, 5, (FULL,), device=cuda, generator=g)
    ids[torch.rand(FULL, device=cuda, generator=g) < 0.3] = 0
    for shape in ((5, 3), (5,)):
        grad = torch.randn((FULL, *shape[1:]), device=cuda, generator=g)
        runs = [segment_sum(grad, ids, shape) for _ in range(5)]
        assert all(torch.equal(r, runs[0]) for r in runs[1:])
        _assert_sums(runs[0], grad, ids, shape)
        table = torch.rand(shape, device=cuda, generator=g).requires_grad_(True)
        (gather.gather_rows(table, ids) * grad).sum().backward()
        assert torch.equal(table.grad, runs[0])


@pytest.mark.parametrize("bad", ["grad_f64", "ids_float", "ids_2d", "grad_rank", "table_rank"])
def test_segment_sum_refuses_what_the_kernel_cannot_take(cuda, bad):
    grad = torch.zeros(8, 3, device=cuda)
    ids = torch.zeros(8, dtype=torch.int64, device=cuda)
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
    before = gather.launches["sum"]
    with pytest.raises(TypeError if bad in ("grad_f64", "ids_float") else ValueError):
        segment_sum(grad, ids, shape)
    assert gather.launches["sum"] == before
