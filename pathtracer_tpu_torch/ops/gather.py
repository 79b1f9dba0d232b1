"""Rows of a material table by id, with a backward of the port's own.

The material gathers (``ops.intersect.material_lookup``, the light's ``Ke``
in ``ops.lights``) are where inverse rendering's gradients reach the
materials: the backward sums every path's gradient into its material's row.
``gather_rows`` runs that sum in ``GatherRows.backward``, inside the
``pt.gather_backward`` span (``utils.profiling``), with the operations of
autograd's own backward of ``table[ids]`` (``index_backward`` in PyTorch's
``FunctionsManual.cpp``: a zero table, then ``_index_put_impl_`` with
``accumulate`` and ``unsafe``), so the gradients are the same bits and the
card runs the same kernels.
"""

from __future__ import annotations

import torch

from pathtracer_tpu_torch.utils.profiling import span


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
            out = grad.new_zeros(ctx.table_shape)
            torch.ops.aten._index_put_impl_(out, [ids], grad, True, True)
        return out, None


def gather_rows(table, ids):
    """``table[ids]`` for [B] ids into a table of rows ([M] or [M, k]);
    through ``GatherRows`` when the table needs a gradient, plain indexing
    otherwise."""
    if torch.is_grad_enabled() and table.requires_grad:
        return GatherRows.apply(table, ids)
    return table[ids]
