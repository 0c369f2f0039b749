"""Batched kinematic G1 replay scene: the Isaac Lab playback's counterpart.

Counterpart of ``bridgerl_tpu/sim/replay.py``. The reference replay
(play_g1_npy.py:159-210) writes root and joint state into PhysX each frame
and renders, never stepping physics. Here the scene holds a resampled
``Motion`` on a device (the card by default) and puts joint frames through
the port's ``BatchedFK`` (eleven levels of a gather and two batched 3x3
products, whatever the number of frames).

``step`` / ``get_next_state`` keep the reference loop's semantics; ``rollout``
takes every frame at once, at the default root as the JAX scene does.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import torch

from ..device import resolve_device
from .kinematics import BatchedFK
from .motion import Motion, load_motion
from .urdf import G1_JOINT_NAMES, KinematicChain, load_g1_chain


class G1ReplayScene:
    """Kinematic replay of (T, 29) joint trajectories on the G1 chain."""

    def __init__(self, chain: Optional[KinematicChain] = None, device=None):
        self.chain = chain or load_g1_chain()
        if self.chain.actuated_names != G1_JOINT_NAMES:
            raise ValueError("chain actuation order must match the canonical 29-joint order")
        self.device = resolve_device(device)
        self._fk = BatchedFK(self.chain)
        self.current_idx = 0
        self.motion: Optional[Motion] = None

    def load(self, dof_pos, input_fps: float = 20.0, output_fps: float = 50.0) -> Motion:
        self.motion = load_motion(dof_pos, input_fps, output_fps, device=self.device)
        self.current_idx = 0
        return self.motion

    # ---- the reference's per-frame API (play_g1_npy.py:147-157) ----
    def get_next_state(self):
        """The current frame's (base_pos, base_rot, base_lin_vel,
        base_ang_vel, dof_pos, dof_vel), and whether the index wrapped to 0
        on advancing past it."""
        m = self.motion
        i = self.current_idx
        state = (m.base_pos[i], m.base_rot[i], m.base_lin_vel[i],
                 m.base_ang_vel[i], m.dof_pos[i], m.dof_vel[i])
        self.current_idx = (self.current_idx + 1) % m.num_frames
        return state, (self.current_idx == 0)

    def step(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """One kinematic frame: (L, 3) positions and (L, 3, 3) rotations at
        the motion's root position (its orientation is not applied, as in
        the JAX scene)."""
        (base_pos, _, _, _, dof_pos, _), _ = self.get_next_state()
        return self._fk(dof_pos, base_pos)

    # ---- every frame at once ----
    def rollout(self, motion: Optional[Motion] = None) -> torch.Tensor:
        """(T, A) -> (T, L, 3) world link positions at the default root."""
        return self.rollout_full(motion)[0]

    def rollout_full(self, motion: Optional[Motion] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(T, A) -> ((T, L, 3) positions, (T, L, 3, 3) rotations) at the
        default root; the volumetric renderer needs the rotations."""
        m = motion or self.motion
        return self._fk(m.dof_pos)

    def fk_windows(self, q_windows) -> torch.Tensor:
        """(N, W, 29) -> (N, W, L, 3): the windowed-state API."""
        q = torch.as_tensor(q_windows, dtype=torch.float32, device=self.device)
        return self._fk(q)[0]

    # ---- throughput (G1 replay steps/s) ----
    def benchmark_steps_per_sec(self, frames: int = 20000, warmup: int = 2) -> float:
        """Frames a second of one rollout of ``frames`` zero frames, after
        ``warmup`` rollouts; reading the sum on the host is the barrier."""
        q = torch.zeros((frames, self.chain.num_actuated), dtype=torch.float32,
                        device=self.device)
        for _ in range(warmup):
            float(self._fk(q)[0].sum())
        t0 = time.perf_counter()
        float(self._fk(q)[0].sum())
        return frames / (time.perf_counter() - t0)

