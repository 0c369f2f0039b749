"""Training: losses, checkpoints, the accumulated optimizer step and the
teacher/student host loop."""
