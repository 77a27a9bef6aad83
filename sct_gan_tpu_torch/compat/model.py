"""`model` shim: keyword-argument constructor parity with
SCT-GAN/model.py:23-36."""
from __future__ import annotations

from ..config import ModelConfig
from ..models.layers import sinusoidal_position_encoding
from ..models.sct_transformer import SmartContractTransformer as _SCT


def SmartContractTransformer(d_model: int = 768, nhead: int = 8,
                             num_encoder_layers: int = 6,
                             num_decoder_layers: int = 6,
                             dim_feedforward: int = 2048,
                             dropout: float = 0.3, max_length: int = 1024,
                             vocab_size: int = 50265,
                             num_vulnerability_types: int = 8,
                             use_gan: bool = False, **config_overrides) -> _SCT:
    """Build the canonical model from the reference's constructor signature."""
    cfg = ModelConfig(
        d_model=d_model, nhead=nhead, num_encoder_layers=num_encoder_layers,
        num_decoder_layers=num_decoder_layers,
        dim_feedforward=dim_feedforward, dropout=dropout,
        max_length=max_length, max_lines=max_length, vocab_size=vocab_size,
        num_vulnerability_types=num_vulnerability_types, use_gan=use_gan,
        **config_overrides)
    return _SCT(cfg)


class PositionalEncoding:
    """Sinusoidal PE table factory (model.py:8-21): adds the (max_len,
    d_model) f32 table to a (B, S, d_model) tensor."""

    def __init__(self, d_model: int, max_len: int = 5000):
        self.pe = sinusoidal_position_encoding(max_len, d_model)

    def __call__(self, x):
        return x + self.pe[None, : x.shape[1], :].to(x.device)
