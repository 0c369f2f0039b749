"""bridgerl_tpu_torch — the PyTorch and CUDA port of ``bridgerl_tpu``.

It serves the flagship retargeting model (transformer towers, hybrid
FSQ + residual-VQ quantizer) on an NVIDIA H100, with hand-written CUDA
kernels for packed-window attention (``ops/attention.py``) and the
nearest-code search (``ops/vq_kernel.py``). Every kernel keeps a plain
PyTorch version beside it, taken for tensors that lie on the CPU.

The package imports ``torch`` and never ``jax`` or ``bridgerl_tpu``.
"""

__version__ = "0.1.0"
