"""The SCT transformer and its layers."""
from .layers import (MultiheadAttention, TransformerDecoderStack,
                     TransformerEncoderStack, line_position_encoding,
                     sinusoidal_position_encoding)
from .sct_transformer import SmartContractTransformer

__all__ = [
    "MultiheadAttention",
    "TransformerEncoderStack",
    "TransformerDecoderStack",
    "sinusoidal_position_encoding",
    "line_position_encoding",
    "SmartContractTransformer",
]
