"""HTTP detection server with micro-batching. Port of
``yoloret_tpu/serve/server.py`` in front of the port's ``Predictor``.

A threaded stdlib HTTP server with a micro-batcher that coalesces
concurrent requests into one fixed-shape device call (padded to
``max_batch``, one of the Predictor's batch buckets). The server only
duck-types the predictor: ``detect_arrays``, ``class_names`` and
``input_hw``.

API:
  POST /detect   body: JPEG/PNG bytes -> {"detections": [{box, score,
                 class_id, class_name}, ...], "latency_ms": float}
  GET  /healthz  -> {"status": "ok", "model": ..., "batch": N}

Run:  python -m yoloret_tpu_torch.serve.server --classes_path ... --anchors_path ...
"""

from __future__ import annotations

import io
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np


class _Pending:
    __slots__ = ("image", "event", "result", "error")

    def __init__(self, image):
        self.image = image
        self.event = threading.Event()
        self.result = None
        self.error: Optional[str] = None


class DetectionServer:
    def __init__(
        self,
        predictor,
        host: str = "0.0.0.0",
        port: int = 8000,
        max_batch: int = 8,
        batch_timeout_ms: float = 5.0,
    ):
        self.predictor = predictor
        self.host = host
        self.port = port
        self.max_batch = max_batch
        self.batch_timeout = batch_timeout_ms / 1e3
        self._q: "queue.Queue[_Pending]" = queue.Queue()
        self._stop = threading.Event()
        self._httpd: Optional[ThreadingHTTPServer] = None

    # -- batching loop -------------------------------------------------------

    def _batcher(self):
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            batch: List[_Pending] = [first]
            deadline = time.perf_counter() + self.batch_timeout
            while len(batch) < self.max_batch:
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=left))
                except queue.Empty:
                    break
            # Pad to max_batch so one compiled shape serves all loads.
            images = [p.image for p in batch]
            while len(images) < self.max_batch:
                images.append(images[0])
            try:
                t0 = time.perf_counter()
                dets = self.predictor.detect_arrays(images)
                ms = (time.perf_counter() - t0) * 1e3
                for p, d in zip(batch, dets):
                    p.result = (d, ms)
                    p.event.set()
            except Exception as e:  # surface errors to the waiting requests
                for p in batch:
                    p.error = str(e)
                    p.event.set()

    def submit(self, image: np.ndarray, timeout: float = 30.0):
        p = _Pending(image)
        self._q.put(p)
        if not p.event.wait(timeout):
            raise TimeoutError("inference timed out")
        if p.error:
            raise RuntimeError(p.error)
        return p.result

    # -- http ---------------------------------------------------------------

    def _handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _json(self, code, obj):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._json(200, {
                        "status": "ok",
                        "classes": len(server.predictor.class_names),
                        "input_hw": list(server.predictor.input_hw),
                        "max_batch": server.max_batch,
                    })
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                if self.path != "/detect":
                    self._json(404, {"error": "not found"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    data = self.rfile.read(n)
                    from PIL import Image

                    img = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
                except Exception as e:
                    self._json(400, {"error": f"bad image: {e}"})
                    return
                try:
                    dets, ms = server.submit(img)
                except Exception as e:
                    self._json(500, {"error": str(e)})
                    return
                self._json(200, {
                    "detections": [
                        {
                            "box": [round(v, 2) for v in d.box],
                            "score": round(d.score, 4),
                            "class_id": d.class_id,
                            "class_name": d.class_name,
                        }
                        for d in dets
                    ],
                    "latency_ms": round(ms, 2),
                })

        return Handler

    def start(self, block: bool = True):
        t = threading.Thread(target=self._batcher, daemon=True)
        t.start()
        self._httpd = ThreadingHTTPServer((self.host, self.port), self._handler())
        self.port = self._httpd.server_address[1]
        if block:
            print(f"serving on {self.host}:{self.port}")
            self._httpd.serve_forever()
        else:
            st = threading.Thread(target=self._httpd.serve_forever, daemon=True)
            st.start()

    def stop(self):
        self._stop.set()
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()


def main(argv=None):
    import argparse

    from yoloret_tpu_torch.infer.predictor import Predictor

    p = argparse.ArgumentParser(description="yoloret detection server (PyTorch/CUDA)")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--backbone", default="mobilenetv2x75")
    p.add_argument("--rfcr", default="weighted_sum", choices=["weighted_sum", "concat", "none"])
    p.add_argument("--weights", default=None, help="saved port state dict")
    p.add_argument("--classes_path", required=True)
    p.add_argument("--anchors_path", required=True)
    p.add_argument("--input_size", type=int, default=320)
    p.add_argument("--score", type=float, default=0.6)
    p.add_argument("--max_batch", type=int, default=8)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    pred = Predictor(
        backbone=a.backbone, weights=a.weights,
        classes_path=a.classes_path, anchors_path=a.anchors_path,
        input_hw=(a.input_size, a.input_size), score_threshold=a.score,
        rfcr=a.rfcr, device=a.device,
    )
    DetectionServer(pred, a.host, a.port, max_batch=a.max_batch).start()


if __name__ == "__main__":
    main()
