"""bridgerl_tpu_torch — the PyTorch and CUDA port of ``bridgerl_tpu``.

It builds, trains (teacher, then student) and serves every model of the
zoo, the four encoder/decoder archs with the seven quantizers, on an NVIDIA
H100, with hand-written CUDA kernels for packed-window attention
(``ops/attention.py``) and the nearest-code search (``ops/vq_kernel.py``),
registered as ``torch.library`` custom ops; freezes a model into a serving
artifact of ``torch.export`` programs (``export/serialize.py``); and runs
the JAX package's data pipeline, training, export and serving command lines
(``cli/``). Every kernel keeps a plain PyTorch version beside it, taken for
tensors that lie on the CPU.

The package imports ``torch`` and never ``jax`` or ``bridgerl_tpu``.
"""

__version__ = "0.1.0"
