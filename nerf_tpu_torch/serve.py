#!/usr/bin/env python
"""Orbit-camera render server over HTTP; counterpart of the top-level ``serve.py``.

    GET /                                  minimal orbit UI (drag to rotate)
    GET /frame?theta=..&phi=..&radius=..   one rendered PNG

Usage:
    python -m nerf_tpu_torch.serve --cfg_file configs/nerf/lego.yaml \\
        trained_model_dir checkpoints/nerf/lego/nerf [--port 8765] [--size 200]

A KiloNeRF config (``configs/nerf/lego_kilonerf.yaml``) serves the model
distilled into ``<trained_model_dir>/kilonerf``. Frames are PNG, encoded by
the port's codec (``utils/png.py``). Every
failed ``/frame`` answers 500, is counted in ``RenderService.errors`` and
has its traceback printed to stderr.
"""
from __future__ import annotations

import argparse
import json
import threading
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Union
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from .config import make_cfg
from .device import resolve_device
from .render.renderer import RenderOptions, render_image
from .run import load_eval_model
from .utils.png import decode_png, encode_png  # noqa: F401  decode_png: for the server's clients
from .utils.profiling import count, span

_PAGE = """<!DOCTYPE html><html><body style="margin:0;background:#222">
<img id=v style="display:block;margin:auto;image-rendering:pixelated;width:600px">
<script>
let th=0.5, ph=0.3, busy=false;
async function update(){
  if (busy) return; busy=true;
  const r = await fetch(`/frame?theta=${th}&phi=${ph}`);
  document.getElementById('v').src = URL.createObjectURL(await r.blob());
  busy=false;
}
let drag=null;
window.onmousedown=e=>drag=[e.clientX,e.clientY];
window.onmouseup=()=>drag=null;
window.onmousemove=e=>{ if(!drag) return;
  th += (e.clientX-drag[0])*0.01; ph += (e.clientY-drag[1])*0.01;
  ph = Math.max(-1.4, Math.min(1.4, ph)); drag=[e.clientX,e.clientY]; update(); };
update();
</script></body></html>"""


def look_at_pose(theta: float, phi: float, radius: float) -> np.ndarray:
    """Orbit camera around the origin (NeRF convention: view along -Z)."""
    pos = radius * np.array([np.cos(phi) * np.sin(theta), np.cos(phi) * np.cos(theta),
                             np.sin(phi)])
    z = pos / np.linalg.norm(pos)
    up = np.array([0.0, 0.0, 1.0])
    x = np.cross(up, z)
    x /= max(np.linalg.norm(x), 1e-8)
    y = np.cross(z, x)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = x, y, z, pos
    return pose


class RenderService:
    """Holds the models and the ESS grid; renders poses one at a time."""

    def __init__(self, cfg, size: int = 200, device: Union[str, torch.device, None] = None):
        self.device = resolve_device(device)
        self.size = size
        self.opts, self.params, self.grid = load_eval_model(cfg, self.device)
        f = 1.39 * size
        self.K = torch.tensor([[f, 0, size / 2], [0, f, size / 2], [0, 0, 1]],
                              dtype=torch.float32, device=self.device)
        self.errors = 0
        self._lock = threading.Lock()

    def render(self, theta: float, phi: float, radius: float,
               opts: Optional[RenderOptions] = None) -> torch.Tensor:
        """rgb [size, size, 3] float32 of the orbit pose, on the device.
        Each frame draws its stratified jitter from a generator seeded with 0,
        as the JAX server uses PRNGKey(0), so a pose always renders alike."""
        pose = torch.as_tensor(look_at_pose(theta, phi, radius), device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(0)
        with span("serve.lock_wait"):
            if not self._lock.acquire(blocking=False):
                count("serve.lock_contended")  # another request holds it: wait
                self._lock.acquire()
        try:
            out = render_image(self.params, pose, self.K, self.size, self.size,
                               opts or self.opts, grid=self.grid, generator=gen)
        finally:
            self._lock.release()
        return out.get("rgb_map", out["rgb_map_0"])

    def render_png(self, theta: float, phi: float, radius: float) -> bytes:
        rgb = self.render(theta, phi, radius).cpu().numpy()
        img = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
        with span("serve.png"):
            return encode_png(img)


def make_handler(service: RenderService):
    class Handler(BaseHTTPRequestHandler):
        timeout = 60  # seconds a client may take to send its request

        def log_message(self, fmt, *args):
            pass

        def _send(self, code: int, ctype: str, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/":
                self._send(200, "text/html", _PAGE.encode())
                return
            if url.path != "/frame":
                self._send(404, "text/plain", b"not found")
                return
            with span("serve.request"):  # the root of the request's spans
                self._frame(url)

        def _frame(self, url):
            q = parse_qs(url.query)
            try:
                args = [float(q.get(name, [default])[0]) for name, default in
                        (("theta", 0.5), ("phi", 0.3), ("radius", 4.0))]
                body = service.render_png(*args)
            except Exception as e:  # the server keeps serving; the failure is reported
                with service._lock:
                    service.errors += 1
                traceback.print_exc()
                self._send(500, "application/json", json.dumps({"error": repr(e)}).encode())
                return
            self._send(200, "image/png", body)

    return Handler


def make_server(service: RenderService, host: str = "127.0.0.1", port: int = 0
                ) -> ThreadingHTTPServer:
    server = ThreadingHTTPServer((host, port), make_handler(service))
    server.daemon_threads = True
    return server


def main(argv=None):
    parser = argparse.ArgumentParser(description="nerf_tpu_torch render server")
    parser.add_argument("--cfg_file", required=True)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8765)
    parser.add_argument("--size", type=int, default=200)
    parser.add_argument("--device", default=None, help="default: cuda")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    args = parser.parse_args(argv)
    service = RenderService(make_cfg(args.cfg_file, args.opts), size=args.size,
                            device=args.device)
    server = make_server(service, args.host, args.port)
    print(f"serving on http://{args.host}:{server.server_address[1]}/ (size {args.size}, "
          f"{service.device})", flush=True)
    try:
        server.serve_forever()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
