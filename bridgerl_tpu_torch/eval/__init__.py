"""Evaluation of the port's outputs: generation statistics."""
