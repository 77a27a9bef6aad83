"""Ops: the kernels' wrappers with their plain versions, and the dense
helpers. The kernels build on their first launch, never at import."""
from .attention import dot_product_attention, mha_reference
from .sampling import sample_categorical, top_k_top_p_filter
from .segment_mean import line_segment_mean

__all__ = [
    "dot_product_attention",
    "mha_reference",
    "line_segment_mean",
    "top_k_top_p_filter",
    "sample_categorical",
]
