from .attention import (
    attention_bwd,
    attention_fwd,
    attention_dropout_mask,
    packed_attention,
    packed_attention_bwd_reference,
    packed_attention_reference,
)
from .code_decode import (
    code_vocab_sizes,
    decode_codes,
    denormalize_codes,
    fsq_codes_to_values,
    fsq_index_range,
    lfq_codes_to_signs,
    normalize_codes,
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
