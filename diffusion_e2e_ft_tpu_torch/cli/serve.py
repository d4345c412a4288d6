"""HTTP inference server for depth / normal estimation on a CUDA device.

Port of `diffusion_e2e_ft_tpu/cli/serve.py`. Loads an HF pipeline directory,
warms up once at the processing resolution, then serves:

  POST /v1/depth    image body (png/jpeg) -> response
  POST /v1/normals  image body (png/jpeg) -> response
  GET  /healthz     readiness probe (200 once warmed up)

Response format by Accept header: `application/x-npy` (default, npy bytes) or
`image/png` (colorized visualization).

    python -m diffusion_e2e_ft_tpu_torch.cli.serve --checkpoint <dir> --half_precision
"""

from __future__ import annotations

import argparse
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from diffusion_e2e_ft_tpu_torch.utils import trace


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, fromfile_prefix_chars="@")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8080)
    p.add_argument("--processing_res", type=int, default=768)
    p.add_argument("--denoise_steps", type=int, default=1)
    p.add_argument("--half_precision", action="store_true", help="run in bfloat16")
    p.add_argument("--device", default="cuda")
    return p


class PipelineService:
    """Holds the warm pipeline; requests run one at a time on the device."""

    def __init__(self, pipe, processing_res: int, denoise_steps: int):
        self.pipe = pipe
        self.processing_res = processing_res
        self.denoise_steps = denoise_steps
        self.lock = threading.Lock()
        self.ready = False

    def warmup(self):
        img = np.zeros((self.processing_res, self.processing_res, 3), np.uint8)
        self.predict(img, normals=False)
        self.ready = True

    def predict(self, rgb: np.ndarray, normals: bool) -> np.ndarray:
        with self.lock, trace.request(self.pipe.device):
            out = self.pipe(
                rgb,
                denoising_steps=self.denoise_steps,
                processing_res=self.processing_res,
                noise="zeros",
                normals=normals,
                color_map=None,
            )
        return out.normal_np if normals else out.depth_np


def make_handler(service: PipelineService):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, code: int, payload: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def do_GET(self):
            if self.path != "/healthz":
                self.send_error(404)
                return
            body = json.dumps({"ready": service.ready}).encode()
            self._send(200 if service.ready else 503, body, "application/json")

        def do_POST(self):
            if self.path not in ("/v1/depth", "/v1/normals"):
                self.send_error(404)
                return
            normals = self.path.endswith("normals")
            length = int(self.headers.get("Content-Length", 0))
            if length <= 0:
                self.send_error(400, "empty body")
                return
            data = self.rfile.read(length)
            from PIL import Image, UnidentifiedImageError

            try:
                rgb = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
            except (UnidentifiedImageError, OSError) as e:
                self.send_error(400, f"bad image: {e}")
                return
            try:
                pred = service.predict(rgb, normals)
            except Exception as e:  # boundary: report the failure as a 500, keep serving
                self.send_error(500, str(e))
                return

            buf = io.BytesIO()
            if "image/png" in self.headers.get("Accept", "application/x-npy"):
                from diffusion_e2e_ft_tpu_torch.ops import image as im

                if normals:
                    vis = im.colorize_normals(pred)
                else:
                    vis = (im.colorize_depth(pred, 0, 1) * 255).astype(np.uint8)
                Image.fromarray(vis).save(buf, format="PNG")
                self._send(200, buf.getvalue(), "image/png")
            else:
                np.save(buf, pred)
                self._send(200, buf.getvalue(), "application/x-npy")

    return Handler


def serve(service: PipelineService, host: str, port: int) -> ThreadingHTTPServer:
    """Start the server on a daemon thread; call `.shutdown()` to stop it."""
    server = ThreadingHTTPServer((host, port), make_handler(service))
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server


def main(argv=None):
    import torch

    from diffusion_e2e_ft_tpu_torch.pipelines import MarigoldPipeline

    args = build_parser().parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda was asked for, but torch sees no CUDA device")
    dtype = torch.bfloat16 if args.half_precision else torch.float32
    pipe = MarigoldPipeline.from_hf_dir(args.checkpoint, device=device, dtype=dtype)
    service = PipelineService(pipe, args.processing_res, args.denoise_steps)
    server = serve(service, args.host, args.port)
    print(f"[serve] warming up at {args.host}:{args.port} ...", flush=True)
    service.warmup()
    print("[serve] ready", flush=True)
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        server.shutdown()


if __name__ == "__main__":
    main()
