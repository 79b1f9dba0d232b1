"""Live render preview over localhost HTTP.

Port of ``pathtracer_tpu/utils/preview_server.py``; ``update`` encodes the
PNG with the port's stdlib writer (``utils.image.encode_png``), not Pillow.
The reference displays the accumulating image on a canvas after every frame
(``src/program-raymarch.ts:317-318`` — ``ctx.putImageData`` per sample).
The CLI equivalent: a stdlib HTTP server on a background thread serving

- ``/``           an auto-refreshing HTML shell (the <canvas> analogue),
- ``/latest.png`` the most recent tonemapped partial render (in-memory),
- ``/status``     JSON {spp_done, spp_total, width, height}.

``update()`` swaps the PNG bytes atomically (the GIL makes the reference
swap safe); renders never block on the server.
"""

from __future__ import annotations

import http.server
import json
import threading

from pathtracer_tpu_torch.utils.image import encode_png

_PAGE = """<!doctype html>
<html><head><title>pathtracer_tpu live preview</title><style>
body {{ background: #111; color: #ddd; font: 14px monospace;
       display: flex; flex-direction: column; align-items: center; }}
img {{ image-rendering: pixelated; margin-top: 1em;
       max-width: 90vw; max-height: 80vh; }}
</style></head><body>
<div id="status">waiting for first sample...</div>
<img id="view" src="/latest.png">
<script>
async function tick() {{
  try {{
    const s = await (await fetch('/status')).json();
    document.getElementById('status').textContent =
      `${{s.width}}x${{s.height}} — ${{s.spp_done}} / ${{s.spp_total}} spp` +
      (s.done ? ' (done)' : '');
    document.getElementById('view').src = '/latest.png?t=' + Date.now();
    if (!s.done) setTimeout(tick, {interval});
  }} catch (e) {{ setTimeout(tick, 1000); }}
}}
tick();
</script></body></html>"""


class PreviewServer:
    """Threaded localhost preview server; see module docstring."""

    def __init__(self, port: int = 8265, refresh_ms: int = 500):
        self._png: bytes = b""
        self._status = {
            "spp_done": 0, "spp_total": 0, "width": 0, "height": 0,
            "done": False,
        }
        self._lock = threading.Lock()
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def log_message(self, *a):  # silent
                pass

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/latest.png":
                    with outer._lock:
                        body = outer._png
                    if not body:
                        self.send_response(404)
                        self.end_headers()
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Cache-Control", "no-store")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif path == "/status":
                    with outer._lock:
                        body = json.dumps(outer._status).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                else:
                    body = _PAGE.format(interval=refresh_ms).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)

        self._httpd = http.server.ThreadingHTTPServer(
            ("127.0.0.1", port), Handler
        )
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True
        )
        self._thread.start()

    def update(self, image_u8, spp_done: int, spp_total: int,
               done: bool = False) -> None:
        """Publish a new partial render (uint8 [H, W, 3] array)."""
        png = encode_png(image_u8)
        with self._lock:
            self._png = png
            self._status = {
                "spp_done": int(spp_done),
                "spp_total": int(spp_total),
                "width": int(image_u8.shape[1]),
                "height": int(image_u8.shape[0]),
                "done": bool(done),
            }

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
