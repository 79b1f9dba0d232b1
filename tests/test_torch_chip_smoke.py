"""``chip_smoke.py``'s checks on the CPU, where each kernel wrapper runs its
plain version: every entry's answer at 4,096 rays or rows passes its checks
against its references (so the plain versions agree with the brute sweep on
the script's rays, parked lanes and zero cutoffs included, and the segment
sum with the float64 sum), a wrong answer fails them, and ptxas's report is
read from a build log."""

import pytest
import torch

import chip_smoke
from pathtracer_tpu_torch import kernels

N = 4096
NAMES = [f"intersect_{k}_{e}" for k in ("small", "shortlist", "tiled", "cluster")
         for e in ("closest", "occluded")] + ["gather_backward_sum_5x3", "gather_backward_sum_5"]

BUILD_LOG = """\
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112small_kernelILb0EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_112small_kernelILb0EEEvPKf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers, 512 bytes smem, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112tiled_kernelILb1EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_112tiled_kernelILb1EEEvPKf
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 255 registers, used 0 barriers, 400 bytes cmem[0]
"""


@pytest.fixture(scope="module")
def entries():
    cpu = torch.device("cpu")
    return {e["name"]: e for e in (chip_smoke.intersection_entries(cpu, N)
                                   + chip_smoke.segment_sum_entries(cpu, N))}


def test_entries_are_the_ten(entries):
    assert list(entries) == NAMES
    for e in entries.values():
        assert e["family"] in kernels.launch_counts() and e["refs"]
        assert chip_smoke.kernel_patterns(e)


@pytest.mark.parametrize("name", NAMES)
def test_entry_passes_its_checks_on_the_cpu(entries, name):
    e = entries[name]
    assert chip_smoke.check(e) == 0.0  # the wrapper is its plain version here
    bound, by = e["bound"]
    assert bound > 0.0 and by in ("operations", "bytes")


def _wrong(out):
    """A closest answer with every finite t one ulp further, any-hit flags
    with one flipped, a table with one element 1.0 off."""
    if isinstance(out, tuple):
        return (_wrong(out[0]), *out[1:])
    if out.dtype == torch.bool:
        return out ^ (torch.arange(out.shape[0]) == out.shape[0] // 3)
    if out.dim() == 1 and out.shape[0] == N:
        return torch.where(torch.isfinite(out),
                           torch.nextafter(out, out.new_tensor(float("inf"))), out)
    return out + (torch.arange(out.numel()) == 0).reshape(out.shape)


@pytest.mark.parametrize("name", ["intersect_cluster_closest", "intersect_small_occluded",
                                  "gather_backward_sum_5x3"])
def test_a_wrong_answer_fails_its_checks(entries, name):
    e = dict(entries[name])
    right = e["call"]
    e["call"] = lambda: _wrong(right())
    with pytest.raises(AssertionError):
        chip_smoke.check(e)


def test_ptxas_reads_each_entry(monkeypatch):
    monkeypatch.setattr(kernels, "build_log", BUILD_LOG)
    assert chip_smoke.ptxas() == {
        "_ZN12_GLOBAL__N_112small_kernelILb0EEEvPKf": [32, 0],
        "_ZN12_GLOBAL__N_112tiled_kernelILb1EEEvPKf": [255, 16]}
