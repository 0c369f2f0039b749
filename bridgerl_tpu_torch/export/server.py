"""Stdlib HTTP serving host over a serving module: a frozen artifact
(``export/serialize.py``) or a live model (``export/serving.py``).

Counterpart of ``bridgerl_tpu/export/server.py``. Endpoints:
    GET  /healthz          {"ok": true, "device": ..., "window": W, ...}
    GET  /meta             the serving module's metadata
    POST /v1/retarget      (b, W, 126) raw human windows -> (b, W, 29) joints
    POST /v1/robot_recon   (b, W, 29)  raw robot windows -> (b, W, 29) recon
    POST /v1/motion_codes  (b, W, 126) raw human windows -> .npz of streams
    POST /v1/decode_codes  .npz of (b, T') int32 streams -> (b, W, 29) robot

Bodies are ``.npy`` bytes (application/octet-stream) or JSON
``{"windows": [[[...]]]}``; ``decode_codes`` takes an ``.npz`` of streams or
JSON ``{"codes": {stream: [[...]]}}``. The response mirrors the request's
format. Batches are rounded up to the next power of two (zero-padded, the
result sliced back), so the device sees a bounded set of shapes; a lock
serialises device work across client threads.
"""

from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Union

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
        """An (b, ...) array, or a dict of them for motion_codes, out. ``x`` is
        an (b, W, D) float array for the functions that take motion, a dict
        of (b, T') integer code streams for decode_codes."""
        sig = self.module.meta["functions"].get(fn_name)
        if sig is None:
            raise KeyError(fn_name)
        if isinstance(sig["input"], dict):
            x = self._check_codes(fn_name, sig, x)
            b = next(iter(x.values())).shape[0]
            pad = _bucket(b) - b if self.bucket_batches else 0
            if pad:
                x = {k: np.concatenate([v, np.zeros((pad, *v.shape[1:]), v.dtype)])
                     for k, v in x.items()}
        else:
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

    @staticmethod
    def _check_codes(fn_name: str, sig, x) -> dict:
        """The streams of ``x`` as int32 arrays, each (b, T') as ``sig`` says;
        a stream of floats is refused rather than truncated."""
        if not isinstance(x, dict):
            raise ValueError(f"{fn_name} expects a dict of code streams {sorted(sig['input'])} "
                             "(npz or JSON 'codes' body)")
        missing, extra = sorted(set(sig["input"]) - set(x)), sorted(set(x) - set(sig["input"]))
        if missing or extra:
            raise ValueError(f"{fn_name} streams mismatch: missing={missing} extra={extra}")
        out, batch = {}, None
        for k, spec in sig["input"].items():
            v = np.asarray(x[k])
            if v.ndim != 2 or v.shape[1] != spec[1] or not (
                    np.issubdtype(v.dtype, np.integer) or v.size == 0):
                raise ValueError(f"{fn_name} stream {k!r} expects (b, {spec[1]}) int32, "
                                 f"got {v.shape} {v.dtype}")
            if batch is None:
                batch = v.shape[0]
            elif v.shape[0] != batch:
                raise ValueError(f"{fn_name} streams disagree on batch size")
            out[k] = v.astype(np.int32)
        return out


def make_server(artifact: Union[str, ServingModule], host: str = "127.0.0.1",
                port: int = 8764, bucket_batches: bool = True,
                device=None) -> ThreadingHTTPServer:
    """Build (but don't start) the HTTP server over a serving module, or over
    the artifact at the path ``artifact`` loaded on ``device`` (the card by
    default); port 0 picks a free one."""
    if isinstance(artifact, str):
        from .serialize import load_serving_artifact

        module = load_serving_artifact(artifact, device=device)
    else:
        module = artifact
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
                dict_input = isinstance(module.meta["functions"][fn_name]["input"], dict)
                if ctype == _JSON:
                    body = json.loads(raw)
                    key = "codes" if dict_input else "windows"
                    if not isinstance(body, dict) or key not in body:
                        raise ValueError(f'JSON body must be {{"{key}": ...}}')
                    x = body["codes"] if dict_input else np.asarray(body["windows"], np.float32)
                elif dict_input:
                    z = np.load(io.BytesIO(raw), allow_pickle=False)
                    if isinstance(z, np.ndarray):
                        raise ValueError(f"{fn_name} expects an .npz of code streams")
                    with z:
                        x = {k: z[k] for k in z.files}
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
