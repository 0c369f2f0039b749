"""Stdlib client for the serving host (export/server.py).

Speaks the npy/npz-over-HTTP protocol:

    from bridgerl_tpu_torch.export.client import ServingClient
    c = ServingClient("http://127.0.0.1:8764")
    joints = c.retarget(human_windows)          # (b, W, 126) -> (b, W, 29)
    recon  = c.robot_recon(robot_windows)       # (b, W, 29)  -> (b, W, 29)
    tokens = c.motion_codes(human_windows)      # -> {stream: (b, T') int32}
    joints = c.decode_codes(tokens)             # -> (b, W, 29)

Arrays travel as .npy/.npz bytes; errors surface as ServingError with the
server's message. urllib and numpy only.
"""

from __future__ import annotations

import io
import json
import urllib.error
import urllib.request
from typing import Any, Dict

import numpy as np

_OCTET = "application/octet-stream"


class ServingError(RuntimeError):
    """Server-reported failure (carries the HTTP status)."""

    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


class ServingClient:
    def __init__(self, base_url: str, timeout: float = 60.0):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    # ---- transport ----

    def _get_json(self, path: str) -> Dict[str, Any]:
        with urllib.request.urlopen(self.base_url + path, timeout=self.timeout) as r:
            return json.loads(r.read())

    def _post_raw(self, fn_name: str, data: bytes) -> bytes:
        req = urllib.request.Request(
            f"{self.base_url}/v1/{fn_name}", data=data,
            headers={"Content-Type": _OCTET}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return r.read()
        except urllib.error.HTTPError as e:
            body = e.read()
            try:
                msg = json.loads(body).get("error", body.decode(errors="replace"))
            except (json.JSONDecodeError, UnicodeDecodeError):
                msg = body.decode(errors="replace")
            raise ServingError(e.code, msg) from None

    def _post(self, fn_name: str, x: np.ndarray) -> bytes:
        buf = io.BytesIO()
        np.save(buf, np.ascontiguousarray(x, dtype=np.float32))
        return self._post_raw(fn_name, buf.getvalue())

    # ---- API ----

    def health(self) -> Dict[str, Any]:
        return self._get_json("/healthz")

    def meta(self) -> Dict[str, Any]:
        return self._get_json("/meta")

    def retarget(self, x_human: np.ndarray) -> np.ndarray:
        return np.load(io.BytesIO(self._post("retarget", x_human)),
                       allow_pickle=False)

    def robot_recon(self, x_robot: np.ndarray) -> np.ndarray:
        return np.load(io.BytesIO(self._post("robot_recon", x_robot)),
                       allow_pickle=False)

    def motion_codes(self, x_human: np.ndarray) -> Dict[str, np.ndarray]:
        npz = np.load(io.BytesIO(self._post("motion_codes", x_human)),
                      allow_pickle=False)
        return {k: npz[k] for k in npz.files}

    def decode_codes(self, codes: Dict[str, np.ndarray]) -> np.ndarray:
        """Code streams -> raw robot windows (the inverse of motion_codes)."""
        buf = io.BytesIO()
        np.savez(buf, **{k: np.ascontiguousarray(v, dtype=np.int32) for k, v in codes.items()})
        return np.load(io.BytesIO(self._post_raw("decode_codes", buf.getvalue())),
                       allow_pickle=False)
