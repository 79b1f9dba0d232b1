"""Rows of a material table by id, with a backward of the port's own.

The material gathers (``ops.intersect.material_lookup``, the light's ``Ke``
in ``ops.lights``) are where inverse rendering's gradients reach the
materials: the backward sums every path's gradient into its material's row.
``gather_rows`` runs that sum in ``GatherRows.backward``, inside the
``pt.gather_backward`` span (``utils.profiling``), by ``segment_sum``.

``segment_sum`` on CPU tensors is the plain version: the operations of
autograd's own backward of ``table[ids]`` (``index_backward`` in PyTorch's
``FunctionsManual.cpp``: a zero table, then ``_index_put_impl_`` with
``accumulate`` and ``unsafe``), so the gradients are the same bits. On CUDA
tensors it launches the kernel of ``csrc/gather_backward.cu``, which sums in
a fixed order of its own: the same sums in another order, the same bits on
every run. ``launches`` counts the kernel's calls.
"""

from __future__ import annotations

import math

import torch

from pathtracer_tpu_torch.utils.profiling import span

# Kernel calls (two launches each: the blocks' partial sums and their sum);
# only the calls below add to it.
launches = {"sum": 0}

_INT_MAX = 2**31 - 1


def segment_sum(grad, ids, table_shape) -> torch.Tensor:
    """The [M] or [M, k] table whose row m is the sum of the rows ``grad[i]``
    with ``ids[i] = m``: ``grad`` [B] or [B, k] float32, ``ids`` [B] int64 or
    int32. On CUDA the kernel; the wrapper checks only what the host knows
    (no id is read: that would wait for the card)."""
    if grad.device.type == "cpu":
        out = grad.new_zeros(table_shape)
        torch.ops.aten._index_put_impl_(out, [ids], grad, True, True)
        return out
    if grad.dtype != torch.float32:
        raise TypeError(f"segment_sum: grad must be float32, got {grad.dtype}")
    if ids.dtype not in (torch.int64, torch.int32):
        raise TypeError(f"segment_sum: ids must be int64 or int32, got {ids.dtype}")
    table_shape = tuple(table_shape)
    if ids.dim() != 1 or len(table_shape) not in (1, 2) or (
            tuple(grad.shape) != (ids.shape[0], *table_shape[1:])):
        raise ValueError(f"segment_sum: grad {tuple(grad.shape)} and ids "
                         f"{tuple(ids.shape)} do not sum into a table {table_shape}")
    if ids.device != grad.device:
        raise ValueError(f"segment_sum: ids on {ids.device}, grad on {grad.device}")
    n, m, k = ids.shape[0], table_shape[0], math.prod(table_shape[1:])
    if n > _INT_MAX or m * k > _INT_MAX:
        raise ValueError(f"segment_sum: {n} rows into {table_shape} exceed the kernel's int")
    from pathtracer_tpu_torch import kernels

    lib = kernels.library()
    grad, ids = grad.contiguous(), ids.contiguous()
    blocks = lib.pt_segment_sum_blocks(n, m, k)
    out = torch.empty(table_shape, dtype=torch.float32, device=grad.device)
    partial = torch.empty(blocks * m * k, dtype=torch.float32, device=grad.device)
    with torch.cuda.device(grad.device):
        rc = lib.pt_segment_sum(
            grad.data_ptr(), ids.data_ptr(), ids.element_size(), n, m, k, blocks,
            partial.data_ptr(), out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    kernels.check(rc, "segment-sum kernel")
    launches["sum"] += 1
    return out


class GatherRows(torch.autograd.Function):
    """``table[ids]`` whose backward sums the rows' gradients by id."""

    @staticmethod
    def forward(ctx, table, ids):
        ctx.save_for_backward(ids)
        ctx.table_shape = table.shape
        return table[ids]

    @staticmethod
    def backward(ctx, grad):
        # Unpacking may replay a checkpointed bounce: outside the span.
        (ids,) = ctx.saved_tensors
        with span("pt.gather_backward"):
            out = segment_sum(grad, ids, ctx.table_shape)
        return out, None


def gather_rows(table, ids):
    """``table[ids]`` for [B] ids into a table of rows ([M] or [M, k]);
    through ``GatherRows`` when the table needs a gradient, plain indexing
    otherwise."""
    if torch.is_grad_enabled() and table.requires_grad:
        return GatherRows.apply(table, ids)
    return table[ids]
