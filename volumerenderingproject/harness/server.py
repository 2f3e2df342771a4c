"""Minimal HTTP render service — the serving counterpart of the reference's
interactive GL viewer (myApp.cu renderLoop + processInput).

The reference explores a volume interactively (WASD orbit, algorithm keys,
O to capture a PNG); this service exposes the same loop statelessly so any
client can drive it:

  GET  /                  -> interactive viewer page (harness/viewer.py)
  GET  /health            -> {"status": "ok", "volume": [...], ...}
  GET  /render?...        -> image/png
  POST /render (JSON)     -> image/png

Query/JSON parameters mirror the CLI: width, height, spr, algorithm
(point|vrc|test), camera ("preset" | "default" | "x,y,z"), orbit
("yaw_deg,pitch_deg,zoom"), lighting (0/1), conic (0/1), scattering (0/1).

The model state (volume + transfer function) is loaded once at startup;
renders are jit-cached per static config, so repeated interactive requests
at one size hit the compiled executable (the reference's
recompute-only-on-camera-move gate, myApp.cu:879, becomes jit caching).

Run: ``python -m volumerenderingproject.harness.server --data x.nii
--port 8040``.
"""

from __future__ import annotations

import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse


class RenderService:
    """Holds the scene and renders frames on demand (thread-safe)."""

    def __init__(self, volume, tf):
        self.volume = volume
        self.tf = tf
        self._lock = threading.Lock()

    @staticmethod
    def from_path(data_path: str) -> "RenderService":
        from ..ingest import load_nifti, synthetic
        from ..scene.transfer_function import default_transfer_function

        if data_path == "sphere":
            volume = synthetic.centered_sphere()
        elif data_path == "corner-sphere":
            volume = synthetic.corner_sphere()
        else:
            volume = load_nifti(data_path)
        return RenderService(volume, default_transfer_function())

    def info(self) -> dict:
        return {
            "status": "ok",
            "volume": list(self.volume.dims),
            "channels": self.volume.channels,
            "cal_max": float(self.volume.cal_max),
        }

    def render_png(self, params: dict) -> bytes:
        import numpy as np

        from ..models.raycast import render, render_jit
        from ..scene.camera import Camera, default_camera, reset_preset
        from ..utils import imageio
        from ..utils.config import Algorithm, RenderConfig

        alg = str(params.get("algorithm", "vrc")).upper()
        config = RenderConfig(
            width=int(params.get("width", 300)),
            height=int(params.get("height", 300)),
            samples_per_ray=int(params.get("spr", 300)),
            algorithm=Algorithm[alg],
            lighting=bool(int(params.get("lighting", 0))),
            scattering=bool(int(params.get("scattering", 0))),
            conic=bool(int(params.get("conic", 0))),
        )
        cam_spec = str(params.get("camera", "preset"))
        if cam_spec == "preset":
            cam = reset_preset()
        elif cam_spec == "default":
            cam = default_camera()
        else:
            pos = tuple(float(v) for v in cam_spec.split(","))
            cam = Camera.initial(
                position=pos,
                screen_w=config.real_screen_width,
                screen_h=config.real_screen_height,
            )
        if "orbit" in params:
            yaw, pitch, zoom = (float(v) for v in str(params["orbit"]).split(","))
            cam = cam.orbit(
                math.radians(yaw),
                math.radians(pitch),
                zoom,
                screen_w=config.real_screen_width,
                screen_h=config.real_screen_height,
            )

        depth = bool(int(params.get("depth", 0)))
        with self._lock:
            if depth:
                # z-buffer visualization (3.3.zbuffershader.fs analog)
                from ..models import point_splat

                if config.algorithm is Algorithm.POINT:
                    img = np.asarray(
                        point_splat.render_points_depth(
                            self.volume, cam, config))
                else:
                    img = np.asarray(
                        point_splat.render_depth_vrc(
                            self.volume, self.tf, cam, config))
            elif config.algorithm is Algorithm.POINT:
                img = np.asarray(render(self.volume, self.tf, cam, config))
            else:
                # jit with static config: repeated interactive requests at one
                # size reuse the compiled executable (the reference's
                # recompute-on-camera-move gate, myApp.cu:879)
                img = np.asarray(render_jit(self.volume, self.tf, cam, config))

        disp = imageio.to_uint8(imageio.to_display(img, config.algorithm))
        return imageio.encode_png(disp[..., :3])


def make_handler(service: RenderService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code: int, message: str):
            self._send(
                code,
                json.dumps({"error": message}).encode(),
                "application/json",
            )

        def do_GET(self):
            url = urlparse(self.path)
            if url.path in ("/", "/viewer"):
                from .viewer import VIEWER_HTML

                self._send(200, VIEWER_HTML.encode(), "text/html")
                return
            if url.path == "/health":
                self._send(
                    200, json.dumps(service.info()).encode(), "application/json"
                )
                return
            if url.path == "/render":
                params = {k: v[0] for k, v in parse_qs(url.query).items()}
                try:
                    png = service.render_png(params)
                except (KeyError, ValueError) as e:
                    self._error(400, f"bad request: {e}")
                    return
                self._send(200, png, "image/png")
                return
            self._error(404, f"unknown path {url.path}")

        def do_POST(self):
            url = urlparse(self.path)
            if url.path != "/render":
                self._error(404, f"unknown path {url.path}")
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                params = json.loads(self.rfile.read(length) or b"{}")
            except json.JSONDecodeError as e:
                self._error(400, f"bad json: {e}")
                return
            try:
                png = service.render_png(params)
            except (KeyError, ValueError) as e:
                self._error(400, f"bad request: {e}")
                return
            self._send(200, png, "image/png")

    return Handler


def serve(
    data_path: str,
    port: int = 8040,
    host: str = "127.0.0.1",
    warmup: bool = False,
) -> ThreadingHTTPServer:
    """Start the server (returns it; call serve_forever / shutdown).

    ``warmup=True`` renders one default frame in the background so the
    first interactive request doesn't pay the jit compile."""
    from ..utils.cache import enable_compile_cache

    enable_compile_cache()
    service = RenderService.from_path(data_path)
    if warmup:
        threading.Thread(
            target=lambda: service.render_png({}), daemon=True
        ).start()
    return ThreadingHTTPServer((host, port), make_handler(service))


def main(argv: Optional[list] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", default="sphere")
    p.add_argument("--port", type=int, default=8040)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the background compile of the default frame")
    args = p.parse_args(argv)
    httpd = serve(args.data, args.port, args.host, warmup=not args.no_warmup)
    print(f"serving {args.data} on http://{args.host}:{args.port}")
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
