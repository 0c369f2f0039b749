"""Stdlib HTTP serving host over the port's in-process serving module.

Counterpart of ``bridgerl_tpu/export/server.py``. Endpoints:
    GET  /healthz          {"ok": true, "device": ..., "window": W, ...}
    GET  /meta             the serving module's metadata
    POST /v1/retarget      (b, W, 126) raw human windows -> (b, W, 29) joints
    POST /v1/robot_recon   (b, W, 29)  raw robot windows -> (b, W, 29) recon
    POST /v1/motion_codes  (b, W, 126) raw human windows -> .npz of streams

Bodies are ``.npy`` bytes (application/octet-stream) or JSON
``{"windows": [[[...]]]}``; the response mirrors the request's format.
Batches are rounded up to the next power of two (zero-padded, the result
sliced back), so the device sees a bounded set of shapes; a lock serialises
device work across client threads.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .serving import ServingModule

_OCTET = "application/octet-stream"
_JSON = "application/json"


def _bucket(b: int) -> int:
    return 1 << max(0, b - 1).bit_length() if b > 1 else 1


def _to_numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy()


class ServingApp:
    """Transport-independent request handling (also the test seam)."""

    def __init__(self, module: ServingModule, bucket_batches: bool = True):
        self.module = module
        self.bucket_batches = bucket_batches
        self._lock = threading.Lock()

    def call(self, fn_name: str, x):
        """(b, W, D) float array in; an (b, ...) array, or a dict of them for
        motion_codes, out."""
        sig = self.module.meta["functions"].get(fn_name)
        if sig is None:
            raise KeyError(fn_name)
        if not isinstance(x, np.ndarray):
            raise ValueError(f"{fn_name} expects a single array body")
        want = (sig["input"][1], sig["input"][2])
        if x.ndim != 3 or x.shape[1:] != want:
            raise ValueError(
                f"{fn_name} expects (b, {want[0]}, {want[1]}) float32, got {x.shape}")
        x = np.asarray(x, np.float32)
        b = x.shape[0]
        if self.bucket_batches and _bucket(b) != b:
            x = np.concatenate([x, np.zeros((_bucket(b) - b, *x.shape[1:]), np.float32)])
        with self._lock:
            out = self.module.fns[fn_name](x)
            if isinstance(out, dict):
                return {k: _to_numpy(v)[:b] for k, v in out.items()}
            return _to_numpy(out)[:b]


def make_server(module: ServingModule, host: str = "127.0.0.1", port: int = 8764,
                bucket_batches: bool = True) -> ThreadingHTTPServer:
    """Build (but don't start) the HTTP server; port 0 picks a free one."""
    app = ServingApp(module, bucket_batches=bucket_batches)
    meta_payload = json.dumps(module.meta).encode()
    health_payload = json.dumps({
        "ok": True, "device": str(module.device), "platform": module.device.type,
        "window": module.window_size, "functions": sorted(module.meta["functions"]),
    }).encode()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _reply(self, code: int, body: bytes, ctype: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code: int, msg: str) -> None:
            self._reply(code, json.dumps({"error": msg}).encode(), _JSON)

        def do_GET(self):  # noqa: N802 (stdlib API name)
            if self.path == "/healthz":
                self._reply(200, health_payload, _JSON)
            elif self.path == "/meta":
                self._reply(200, meta_payload, _JSON)
            else:
                self._error(404, f"no such path {self.path!r}")

        def do_POST(self):  # noqa: N802
            if not self.path.startswith("/v1/"):
                return self._error(404, f"no such path {self.path!r}")
            fn_name = self.path[len("/v1/"):]
            if fn_name not in module.meta["functions"]:
                return self._error(404, f"unknown function {fn_name!r}")
            try:
                raw = self.rfile.read(int(self.headers.get("Content-Length", 0)))
                ctype = (self.headers.get("Content-Type") or _OCTET).split(";")[0]
                if ctype == _JSON:
                    body = json.loads(raw)
                    if not isinstance(body, dict) or "windows" not in body:
                        raise ValueError('JSON body must be {"windows": ...}')
                    x = np.asarray(body["windows"], np.float32)
                else:
                    x = np.load(io.BytesIO(raw), allow_pickle=False)
                    if not isinstance(x, np.ndarray):
                        raise ValueError("octet body must be a single .npy array")
                out = app.call(fn_name, x)
            # a malformed body is a client error: answer 400, never drop the socket
            except (ValueError, TypeError, EOFError, OSError,
                    json.JSONDecodeError) as e:
                return self._error(400, str(e) or type(e).__name__)
            buf = io.BytesIO()
            if isinstance(out, dict):  # motion_codes: one stream per key
                if ctype == _JSON:
                    body = {"codes": {k: v.tolist() for k, v in out.items()}}
                    return self._reply(200, json.dumps(body).encode(), _JSON)
                np.savez(buf, **out)
            elif ctype == _JSON:
                return self._reply(200, json.dumps({"windows": out.tolist()}).encode(),
                                   _JSON)
            else:
                np.save(buf, out)
            self._reply(200, buf.getvalue(), _OCTET)

    srv = ThreadingHTTPServer((host, port), Handler)
    srv.app = app
    return srv
