"""Streaming overlap-add retargeting: live deployment with bounded latency.

Counterpart of ``bridgerl_tpu/export/streaming.py``, in numpy only (it
imports no torch, so a client host needs none). Push raw frames one at a
time and receive output frames as soon as they are final; the windows and
their averaging are offline overlap-add's (``export/reconstruct.py``).

Finality: windows start on the stride grid {0, S, 2S, ...} while
start + W <= T, plus one tail window at T - W. Frame i can still gain
coverage from a future grid window with start <= i until the stream holds
i + W frames, and from the tail window [T - W, T) until it holds i + W + 1.
So frame i is final exactly when n >= i + W + 1: the latency is W + 1
frames, and the values equal offline overlap-add's up to float summation
order.

It takes any raw-in/raw-out window function: a live serving module's or a
frozen artifact's ``retarget`` / ``robot_recon`` (``export/serialize.py``),
where the input width (126, human) need not equal the output's (29, robot):

    mod = load_serving_artifact("serving/model.zip")
    sr = StreamingRetargeter(mod.retarget, window=10, step=5, in_dim=126)
    for frame in motion_feed:             # (126,) raw human frames
        for joints in sr.push(frame):     # (29,) raw robot frames, in order
            robot.command(joints)
    for joints in sr.flush():             # the tail, with the T-W tail window
        robot.command(joints)
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np


def window_starts(seq_len: int, window: int, step: int) -> np.ndarray:
    """range(0, T-W+1, step), plus a tail window at T-W if the strided sweep
    stopped short."""
    starts = list(range(0, seq_len - window + 1, step))
    cursor = starts[-1] + step if starts else 0
    if cursor < seq_len:
        if not starts or starts[-1] != seq_len - window:
            starts.append(seq_len - window)
    return np.asarray(starts, dtype=np.int32)


class StreamingRetargeter:
    """Incremental sliding-window overlap-add over a raw window function.

    window_fn: (k, W, in_dim) float32 -> (k, W, out_dim), an array or a torch
    tensor (moved to the host); called with k=1 as windows complete
    (per-request batching is the serving host's job).
    """

    def __init__(self, window_fn: Callable, window: int, step: int,
                 in_dim: int, out_dim: Optional[int] = None):
        if step <= 0 or window <= 0:
            raise ValueError(f"window/step must be positive, got {window}/{step}")
        self.window_fn = window_fn
        self.W, self.S = int(window), int(step)
        self.in_dim = int(in_dim)
        self.out_dim = int(out_dim) if out_dim is not None else None
        self.n = 0                 # frames pushed
        self._emit_next = 0        # first not-yet-emitted frame index
        self._ring = np.zeros((self.W, self.in_dim), np.float32)  # last W frames
        self._next_start = 0       # next grid window start to process
        # output accumulators for frames [_base, n): small — O(W + S) rows.
        # Column count is out_dim when known up front, else a 1-column
        # placeholder re-shaped on the first window's output (_run_window).
        self._base = 0
        self._sum = np.zeros((0, self.out_dim or 1), np.float32)
        self._cnt = np.zeros((0, 1), np.float32)

    # ---- internals ----

    def _ensure_out(self, upto: int) -> None:
        """Grow the accumulator rows to cover frame indices [_base, upto)."""
        need = upto - self._base - self._sum.shape[0]
        if need > 0:
            d = self._sum.shape[1]
            self._sum = np.concatenate([self._sum, np.zeros((need, d), np.float32)])
            self._cnt = np.concatenate([self._cnt, np.zeros((need, 1), np.float32)])

    def _run_window(self, start: int, x_win: np.ndarray) -> None:
        out = self.window_fn(x_win[None].astype(np.float32))
        if hasattr(out, "detach"):   # a torch tensor, maybe on the card
            out = out.detach().cpu().numpy()
        out = np.asarray(out)[0]
        if self.out_dim is None:
            self.out_dim = out.shape[-1]
            self._sum = np.zeros((self._sum.shape[0], self.out_dim), np.float32)
        elif out.shape[-1] != self.out_dim:
            raise ValueError(
                f"window_fn returned out_dim={out.shape[-1]}, expected {self.out_dim}")
        self._ensure_out(start + self.W)
        lo = start - self._base
        self._sum[lo:lo + self.W] += out.astype(np.float32)
        self._cnt[lo:lo + self.W] += 1.0

    def _emit_upto(self, upto: int) -> np.ndarray:
        """Finalize and release frames [_emit_next, upto)."""
        if upto <= self._emit_next:
            return np.zeros((0, self.out_dim or 0), np.float32)
        self._ensure_out(upto)
        lo, hi = self._emit_next - self._base, upto - self._base
        out = self._sum[lo:hi] / np.maximum(self._cnt[lo:hi], 1.0)
        self._sum, self._cnt = self._sum[hi:], self._cnt[hi:]
        self._base = upto
        self._emit_next = upto
        return out

    # ---- API ----

    def push(self, frame: np.ndarray) -> np.ndarray:
        """Add one raw input frame; returns the (m, out_dim) frames (m >= 0)
        that became final, in stream order."""
        frame = np.asarray(frame, np.float32)
        if frame.shape != (self.in_dim,):
            raise ValueError(f"expected frame shape ({self.in_dim},), got {frame.shape}")
        self._ring = np.roll(self._ring, -1, axis=0)
        self._ring[-1] = frame
        self.n += 1
        # grid window [next_start, next_start + W) completes at n = start + W;
        # completion points are S apart, so at most one completes per push and
        # the ring then holds exactly frames [n - W, n) = the window
        if self._next_start + self.W <= self.n:
            self._run_window(self._next_start, self._ring[-self.W:])
            self._next_start += self.S
        # frame i final once n >= i + W + 1
        return self._emit_upto(max(self.n - self.W - 1 + 1, 0)) \
            if self.out_dim is not None else np.zeros((0, 0), np.float32)

    def flush(self) -> np.ndarray:
        """End of stream: process the tail window and return every remaining
        final frame. Returns (0, out_dim) when T <= window, matching the
        offline path, which returns None there."""
        T = self.n
        if T <= self.W:
            return np.zeros((0, self.out_dim or 0), np.float32)
        # grid windows are all processed (their completion point has passed);
        # the reference placement may add one off-grid tail window at T - W,
        # which window_starts places for both paths
        for s in window_starts(T, self.W, self.S):
            if s % self.S != 0:  # the off-grid tail (ring holds [T-W, T))
                self._run_window(int(s), self._ring[-self.W:])
        return self._emit_upto(T)

    @property
    def latency_frames(self) -> int:
        """Worst-case frames between pushing frame i and receiving it."""
        return self.W + 1
