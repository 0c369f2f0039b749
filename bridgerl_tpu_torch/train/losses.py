"""Loss functions and evaluation metrics.

Counterpart of ``bridgerl_tpu/train/losses.py``. Teacher loss:
``lambda_recon * MSE(recon, x) + lambda_vq * loss_vq + lambda_vel * vel``,
where the velocity term differences the CHANNEL axis with ``ref_exact_vel``
(the reference's literal ``[:, :, 1:] - [:, :, :-1]``, the default) and the
time axis without it. Student loss: ``lambda_align * MSE(z_e_human,
sg(z_e_robot))``. Validation always differences the time axis.
:func:`fk_loss` is the world-space forward-kinematics term that
``lambda_fk`` adds to the teacher loss.
:func:`info_nce_loss` is the reference's contrastive alignment loss, which no
default uses.
"""

from __future__ import annotations

from typing import Dict

import torch


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean((a.float() - b.float()) ** 2)


def time_diff(x: torch.Tensor, n: int = 1) -> torch.Tensor:
    """n-th order finite difference along the time axis (dim 1) of (B, T, C)."""
    for _ in range(n):
        x = x[:, 1:] - x[:, :-1]
    return x


def channel_diff(x: torch.Tensor) -> torch.Tensor:
    """First-order difference along the channel axis of (B, T, C)."""
    return x[:, :, 1:] - x[:, :, :-1]


def velocity_loss(recon: torch.Tensor, real: torch.Tensor,
                  ref_exact: bool = False) -> torch.Tensor:
    if ref_exact:
        return mse(channel_diff(recon), channel_diff(real))
    return mse(time_diff(recon, 1), time_diff(real, 1))


def jerk_loss(recon: torch.Tensor, real: torch.Tensor) -> torch.Tensor:
    """3rd-order time-difference MSE; zero for windows under 4 frames."""
    if real.shape[1] < 4:
        return torch.zeros((), dtype=real.dtype, device=real.device)
    return mse(time_diff(recon, 3), time_diff(real, 3))


def teacher_loss(recon: torch.Tensor, x_robot: torch.Tensor, loss_vq: torch.Tensor,
                 lambda_recon: float = 1.0, lambda_vq: float = 1.0,
                 lambda_vel: float = 0.5, ref_exact_vel: bool = False
                 ) -> Dict[str, torch.Tensor]:
    l_recon = mse(recon, x_robot)
    l_vel = velocity_loss(recon, x_robot, ref_exact=ref_exact_vel)
    total = lambda_recon * l_recon + lambda_vq * loss_vq + lambda_vel * l_vel
    return {"loss": total, "recon_loss": l_recon, "vq_loss": loss_vq, "vel_loss": l_vel}


def student_loss(z_e_human: torch.Tensor, z_e_robot: torch.Tensor,
                 lambda_align: float = 100.0) -> Dict[str, torch.Tensor]:
    l_align = mse(z_e_human, z_e_robot.detach())
    return {"loss": lambda_align * l_align, "align_loss": l_align}


def fk_loss(recon: torch.Tensor, real: torch.Tensor, fk_fn) -> torch.Tensor:
    """MSE between the world link positions of the reconstructed and the
    real joint windows, in float32 whatever the compute dtype. ``fk_fn``
    maps (B, W, 29) joint radians to (B, W, L, 3) positions
    (``sim.kinematics.make_batched_fk``); the data are raw radians, so FK
    applies directly and the loss is differentiable end to end."""
    return mse(fk_fn(recon.float()), fk_fn(real.float()))


def info_nce_loss(z_h: torch.Tensor, z_r: torch.Tensor, temperature: float = 0.07
                  ) -> torch.Tensor:
    """Symmetric contrastive loss between the rows of two latent batches
    (train_ablation.py:71-78; the reference abandoned it for the direct MSE,
    README.md:322)."""
    zh, zr = z_h.reshape(z_h.shape[0], -1), z_r.reshape(z_r.shape[0], -1)
    zh = zh / torch.clamp(torch.linalg.norm(zh, dim=-1, keepdim=True), min=1e-8)
    zr = zr / torch.clamp(torch.linalg.norm(zr, dim=-1, keepdim=True), min=1e-8)
    logits = zh @ zr.t() / temperature
    diag = torch.diagonal(logits)
    loss_h = torch.mean(torch.logsumexp(logits, dim=1) - diag)
    loss_r = torch.mean(torch.logsumexp(logits.t(), dim=1) - diag)
    return 0.5 * (loss_h + loss_r)


def eval_metrics(outputs, x_robot: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The validation metric schema for one batch."""
    m: Dict[str, torch.Tensor] = {}
    if "robot" in outputs:
        recon = outputs["robot"]["recon"]
        m["val_recon"] = mse(recon, x_robot)
        m["val_vel"] = velocity_loss(recon, x_robot)
        m["val_jerk"] = jerk_loss(recon, x_robot)
        qm = outputs["robot"]["metrics"]
        m["perplexity"] = qm["perplexity"]
        m["dcr"] = qm["dcr"]
        if "rvq_ppl" in qm:
            m["rvq_ppl"] = qm["rvq_ppl"]
    if "human" in outputs:
        m["val_cross_recon"] = mse(outputs["human"]["retargeted"], x_robot)
        if "robot" in outputs:
            m["val_align"] = mse(outputs["human"]["z_e"], outputs["robot"]["z_e"])
    return m
