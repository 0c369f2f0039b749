"""Data: the on-device paired dataset, the preprocessing pipeline, the
synthetic generator and the rotation conversion they use."""
