"""Training: losses, checkpoints, codebook seeding, the accumulated optimizer
step and the teacher/student host loop."""

from .losses import info_nce_loss, student_loss, teacher_loss

__all__ = ["info_nce_loss", "student_loss", "teacher_loss"]
