from .dual_vqvae import DualMotionVQVAE, init_model
from .layers import (
    TransformerBlock,
    TransformerMotionDecoder,
    TransformerMotionEncoder,
    block_diagonal_mask,
    sinusoidal_pe,
)
