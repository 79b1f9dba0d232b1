"""Both CLIs render the same generated INI/XML/OBJ assets at 16x16, spp 2:
the PNGs differ by at most one 8-bit step on at least 99% of pixels
(float rounding differs in the last bits, which can flip a rounding to
8 bits). The port's CLI extras on the CPU: ``--intersector bvh``,
``--checkpoint`` resuming a cut render, ``--preview-png`` and ``--serve``."""

import os
import urllib.request

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


def test_cli_unported_intersector_raises(ini, tmp_path, capsys):
    """``--intersector bvh``, which raised until the BVH oracle was ported,
    renders: its PNG agrees with the default route's (brute on the CPU; the
    walk's t is bit-equal to brute's). A name the CLI does not know is
    refused by argparse."""
    assert torch_main([ini, "--device", "cpu", "--intersector", "bvh",
                       "--out", str(tmp_path / "bvh.png")]) == 0
    assert torch_main([ini, "--device", "cpu", "--out", str(tmp_path / "auto.png")]) == 0
    assert _same_png(tmp_path / "bvh.png", tmp_path / "auto.png")
    with pytest.raises(SystemExit):
        torch_main([ini, "--device", "cpu", "--intersector", "octree",
                    "--out", str(tmp_path / "x.png")])
    capsys.readouterr()


def _same_png(a, b) -> bool:
    """Equal up to summation order: at most one 8-bit step on any value, on
    at most 0.1% of them (a chunked render sums a pixel's samples in
    another order, which can flip a rounding to 8 bits)."""
    diff = np.abs(_pixels(a) - _pixels(b))
    return diff.shape == (16, 16, 3) and diff.max() <= 1 and (diff > 0).mean() <= 1e-3


def test_cli_checkpoint_resumes(ini, tmp_path):
    """A render cut after its first chunk (by a progress callback through
    render_checkpointed) and resumed by ``--checkpoint`` writes the straight
    render's PNG; a rerun on the finished state traces nothing."""
    from pathtracer_tpu_torch.models.scene import load_scene
    from pathtracer_tpu_torch.render import render_checkpointed
    from pathtracer_tpu_torch.utils.checkpoint import load_render_state, render_fingerprint

    ckpt = str(tmp_path / "state.npz")
    scene, camera, settings, _ = load_scene(ini, device="cpu", seed=0)

    def cut(done, total):
        raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        render_checkpointed(scene, camera, settings, ckpt, chunk_samples=1,
                            progress_callback=cut)
    fp = render_fingerprint(scene, settings)
    assert load_render_state(ckpt, fp)[1] == 1
    args = [ini, "--device", "cpu", "--checkpoint", ckpt]
    assert torch_main([*args, "--out", str(tmp_path / "resumed.png")]) == 0
    assert load_render_state(ckpt, fp)[1] == 2
    assert torch_main([ini, "--device", "cpu", "--out", str(tmp_path / "straight.png")]) == 0
    assert _same_png(tmp_path / "resumed.png", tmp_path / "straight.png")
    assert torch_main([*args, "--out", str(tmp_path / "again.png")]) == 0
    assert (tmp_path / "again.png").read_bytes() == (tmp_path / "resumed.png").read_bytes()


def test_cli_preview_png(ini, tmp_path):
    """``--preview-png 2`` at spp 8 writes <out>.preview_0002/4/6.png, and
    the final PNG is the straight render's."""
    out = tmp_path / "r.png"
    assert torch_main([ini, "--device", "cpu", "--spp", "8", "--preview-png", "2",
                       "--out", str(out)]) == 0
    previews = sorted(p.name for p in tmp_path.glob("r.preview_*.png"))
    assert previews == ["r.preview_0002.png", "r.preview_0004.png", "r.preview_0006.png"]
    for name in previews:
        assert _pixels(tmp_path / name).shape == (16, 16, 3)
    assert torch_main([ini, "--device", "cpu", "--spp", "8",
                       "--out", str(tmp_path / "straight.png")]) == 0
    assert _same_png(out, tmp_path / "straight.png")


def test_cli_serve_free_port(ini, tmp_path, monkeypatch, capsys):
    """``--serve 0`` serves on a free port, publishes every sample and a
    final ``done=True`` update, closes the server and exits 0."""
    from pathtracer_tpu_torch.utils import preview_server

    updates = []
    publish = preview_server.PreviewServer.update

    def update(self, image_u8, spp_done, spp_total, done=False):
        updates.append((image_u8.shape, spp_done, spp_total, done))
        publish(self, image_u8, spp_done, spp_total, done)

    monkeypatch.setattr(preview_server.PreviewServer, "update", update)
    assert torch_main([ini, "--device", "cpu", "--spp", "3", "--serve", "0",
                       "--out", str(tmp_path / "s.png")]) == 0
    err = capsys.readouterr().err
    port = int(err.split("live preview: http://127.0.0.1:")[1].split("/")[0])
    assert port > 0
    assert updates == [((16, 16, 3), 1, 3, False), ((16, 16, 3), 2, 3, False),
                       ((16, 16, 3), 3, 3, True)]
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/status", timeout=5)
