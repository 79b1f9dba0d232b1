"""Both CLIs render the same generated INI/XML/OBJ assets at 16x16, spp 2:
the PNGs differ by at most one 8-bit step on at least 99% of pixels
(float rounding differs in the last bits, which can flip a rounding to
8 bits)."""

import os

import numpy as np
import pytest

from pathtracer_tpu.cli import main as jax_main
from pathtracer_tpu_torch.cli import main as torch_main
from pathtracer_tpu_torch.models.procedural import write_cornell_box_files
from pathtracer_tpu_torch.ops import intersect_small


@pytest.fixture(scope="module")
def ini(tmp_path_factory):
    return write_cornell_box_files(str(tmp_path_factory.mktemp("assets")),
                                   width=16, height=16, samples_per_pixel=2)


def _pixels(path):
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"), np.int16)


def test_cli_pngs_agree(ini, tmp_path, capsys):
    assert jax_main([ini, "--out", str(tmp_path / "jax.png")]) == 0
    jax_out = capsys.readouterr().out
    assert torch_main([ini, "--out", str(tmp_path / "port.png"), "--device", "cpu"]) == 0
    port_out = capsys.readouterr().out
    # Same report lines (timings aside).
    assert jax_out.splitlines()[:2] == port_out.splitlines()[:2]
    a, b = _pixels(tmp_path / "jax.png"), _pixels(tmp_path / "port.png")
    assert a.shape == b.shape == (16, 16, 3)
    assert (np.abs(a - b).max(-1) <= 1).mean() >= 0.99
    assert intersect_small.launches == {"closest": 0, "occluded": 0}


def test_cli_writes_ini_output_path(ini, monkeypatch):
    monkeypatch.chdir(os.path.dirname(ini))
    assert torch_main([ini, "--device", "cpu", "--scheduler", "scan",
                       "--size", "8", "--spp", "1"]) == 0
    assert _pixels("out/cornell.png").shape == (8, 8, 3)


def test_cli_unported_intersector_raises(ini, tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        torch_main([ini, "--device", "cpu", "--intersector", "bvh",
                    "--out", str(tmp_path / "x.png")])
