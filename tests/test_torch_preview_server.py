"""The port's live preview server (utils.preview_server), without Pillow:
the port of tests/test_preview_server.py, with its PNG read back by the
port's stdlib reader, plus encode_png against write_png."""

import json
import sys
import urllib.error
import urllib.request

import numpy as np

from pathtracer_tpu_torch.utils.image import encode_png, read_png, write_png
from pathtracer_tpu_torch.utils.preview_server import PreviewServer


def test_preview_server_serves_updates(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)  # importing Pillow fails
    srv = PreviewServer(port=0)  # ephemeral port
    try:
        base = f"http://127.0.0.1:{srv.port}"
        # Before any update: page served, image 404.
        page = urllib.request.urlopen(f"{base}/").read()
        assert b"latest.png" in page
        try:
            urllib.request.urlopen(f"{base}/latest.png")
            raise AssertionError("expected 404 before first update")
        except urllib.error.HTTPError as e:
            assert e.code == 404

        img = np.zeros((8, 6, 3), np.uint8)
        img[..., 0] = 200
        img[2, 3] = (1, 2, 3)
        srv.update(img, spp_done=3, spp_total=16)
        png = urllib.request.urlopen(f"{base}/latest.png").read()
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        (tmp_path / "latest.png").write_bytes(png)
        np.testing.assert_array_equal(read_png(str(tmp_path / "latest.png")),
                                      img.astype(np.float32) / 255.0)
        status = json.loads(urllib.request.urlopen(f"{base}/status").read())
        assert status == {
            "spp_done": 3, "spp_total": 16, "width": 6, "height": 8,
            "done": False,
        }

        srv.update(img, spp_done=16, spp_total=16, done=True)
        status = json.loads(urllib.request.urlopen(f"{base}/status").read())
        assert status["done"] is True
    finally:
        srv.close()


def test_encode_png_is_write_png_bytes(tmp_path):
    img = np.random.default_rng(1).random((5, 7, 3)).astype(np.float32) * 1.2
    write_png(str(tmp_path / "a.png"), img)
    assert (tmp_path / "a.png").read_bytes() == encode_png(img)
