from .attention import (
    PackedAttention,
    attention_dropout_mask,
    packed_attention,
    packed_attention_bwd_reference,
    packed_attention_reference,
)
from .codebook import assignment_stats, nearest_codes, nearest_codes_plain, quantize_lookup
from .kernels import COUNTERS, build_all, reset_counters
from .quantizers import (
    FSQ,
    LFQ,
    HybridVQ,
    IdentityVQ,
    ResidualVQ,
    VectorQuantizer,
    dcr_from_counts,
    make_quantizer,
    perplexity_from_counts,
    ste,
    unique_count,
)
from .vq_kernel import nearest_codes_cuda
