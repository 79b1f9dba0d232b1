"""``correct`` has to come out false when the timed path is broken or when
the reference stands in the program's place in a lower precision.

The faults run the whole of a cell's run on the CPU at test sizes, past the
harness's look for a card, with the program's entry broken underneath; the
control is the reference in bfloat16 against the reference in float32, here
at test sizes and, on a card, at the cell's own size."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import control, harness
from benchmark.tests.conftest import SMALL, spec_with_left_out

RENDER_CELLS = ["cornell_render_512_spp50", "cornell_preview_512_scan"]


@pytest.mark.parametrize("cell", RENDER_CELLS)
@pytest.mark.parametrize("fault", sorted(control.RENDER_FAULTS))
def test_render_faults_fail(cell, fault, cell_run):
    with control.planted(control.RENDER_FAULTS[fault]):
        _, _, line = cell_run(cell)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("fault", sorted(control.FIT_FAULTS))
def test_fit_faults_fail(fault, cell_run):
    with control.planted(control.FIT_FAULTS[fault]):
        _, _, line = cell_run("cornell_fit_512")
    assert line["correct"] is False, line["checks"]


def test_stale_samples_fail_in_the_window(cell_run):
    """A fault that begins after the warm-up leaves the start's numbers
    sound; the window step's numbers catch it."""
    with control.planted(control.FIT_FAULTS["stale_samples"]):
        _, _, line = cell_run("cornell_fit_512")
    c = line["checks"]
    assert all(c[n]["value"] <= c[n]["limit"] for n in ("loss_gap", "grad_gap", "change_gap"))
    assert line["correct"] is False, c


@pytest.mark.parametrize("cell", RENDER_CELLS + ["cornell_fit_512"])
def test_sound_runs_pass(cell, cell_run):
    _, _, line = cell_run(cell)
    assert line["correct"] is True, line["checks"]


def _control_readings(cell_name, seed, device, overrides):
    spec = spec_with_left_out()
    cell = harness.load_cell(cell_name, spec)
    ctx = harness.Context(cell=cell, config=harness.load_config(cell["config"]), seed=seed,
                          seconds=0.0, trace=False, device=device, t0=time.perf_counter(),
                          workdir="", overrides=overrides)
    if cell["driver"] == "fit":
        readings = control.control_fit(ctx, seed)
    else:
        k = 2 if cell["driver"] == "preview" else None
        readings = control.control_render(ctx, seed, k)
    return cell, readings


@pytest.mark.parametrize("cell_name", RENDER_CELLS + ["cornell_fit_512"])
def test_control_fails(cell_name):
    """The reference in bfloat16 in the program's place fails one of the
    cell's numbers, at test sizes."""
    cell, readings = _control_readings(cell_name, 2**31 + 5, "cpu", SMALL)
    assert any(v > cell["limits"][n] for n, v in readings), readings


@pytest.mark.gpu
@pytest.mark.parametrize("cell_name", RENDER_CELLS + ["cornell_fit_512"])
def test_control_fails_at_cell_size(cell_name):
    """The same at the cell's own size, on three seeds (needs the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's own size")
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        cell, readings = _control_readings(cell_name, seed, "cuda", {})
        assert any(v > cell["limits"][n] for n, v in readings), readings
