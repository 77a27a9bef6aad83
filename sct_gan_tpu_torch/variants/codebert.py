"""Frozen CodeBERT (RoBERTa-base) embedder of the port.

Counterpart of ``sct_gan_tpu/variants/codebert.py``. The TASC variants embed
the contract and AST-path token streams with a frozen
``microsoft/codebert-base`` encoder and sum the two embeddings. The
architecture: learned positions with RoBERTa's padding-offset ids, then
post-norm layers (attention, exact-erf GELU FFN). Module and parameter
names follow the flax tree, so ``convert.py`` maps it by rule.

``load_codebert_params`` takes a locally cached HF model when
``transformers`` and the weights are there, and never downloads; otherwise
it returns a seeded random initialisation of the same shapes.

Precision: ``CodeBERTConfig.compute_dtype`` is the dtype of the matmuls and
the attention; parameters and LayerNorm outputs are f32 (flax's promotion
for a LayerNorm without a dtype). The JAX trainer runs the embedder in f32;
the port's TASC trainer runs it in the TASC config's compute dtype, because
the card's attention kernel (K1, head dim 64 with the key mask) takes bf16.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import CodeBERTConfig
from ..models.layers import Dense, Embed, LayerNorm, MultiheadAttention

ROBERTA_PAD_ID = 1
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def lecun_normal_init(w: torch.Tensor,
                      g: Optional[torch.Generator]) -> torch.Tensor:
    """flax's default Dense kernel init (``lecun_normal``): a normal of
    variance 1/fan_in truncated at two standard deviations."""
    std = math.sqrt(1.0 / w.shape[1]) / 0.87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=g)


class RobertaEmbeddings(nn.Module):
    """Word + position + token-type embeddings, then LayerNorm."""

    def __init__(self, vocab_size: int, d_model: int, max_positions: int,
                 dtype: torch.dtype):
        super().__init__()
        self.word_embeddings = Embed(vocab_size, d_model)
        self.position_embeddings = Embed(max_positions, d_model)
        self.token_type_embeddings = Embed(1, d_model)
        self.layer_norm = LayerNorm(d_model, torch.float32)
        self.dtype = dtype

    def forward(self, input_ids, attention_mask):
        # RoBERTa position ids: pad positions stay at pad_id, real tokens
        # count from pad_id + 1 (HF create_position_ids_from_input_ids)
        mask = attention_mask.long()
        pos_ids = torch.cumsum(mask, dim=1) * mask + ROBERTA_PAD_ID
        x = (self.word_embeddings(input_ids)
             + self.position_embeddings(pos_ids)
             + self.token_type_embeddings(torch.zeros_like(input_ids)))
        return self.layer_norm(x).to(self.dtype)


class RobertaLayer(nn.Module):
    """Post-norm transformer layer (BERT/RoBERTa style)."""

    def __init__(self, d_model: int, num_heads: int, dim_feedforward: int,
                 dtype: torch.dtype):
        super().__init__()
        self.attention = MultiheadAttention(d_model, num_heads, 0.0, dtype)
        self.attention_norm = LayerNorm(d_model, torch.float32)
        self.intermediate = Dense(d_model, dim_feedforward, dtype,
                                  lecun_normal_init)
        self.output = Dense(dim_feedforward, d_model, dtype,
                            lecun_normal_init)
        self.output_norm = LayerNorm(d_model, torch.float32)

    def forward(self, x, key_padding_mask=None):
        attn = self.attention(x, x, x, key_padding_mask=key_padding_mask)
        x = self.attention_norm(x + attn)
        # exact (erf) GELU in every dtype, as codebert.py:73 of the JAX
        # package calls it (not models/layers.py's gelu)
        h = F.gelu(self.intermediate(x))
        return self.output_norm(x + self.output(h))


class FlaxCodeBERT(nn.Module):
    """RoBERTa-base encoder: embeddings + N post-norm layers.

    Takes the JAX module's keyword arguments (plus ``compute_dtype``) or,
    through ``from_config``, a ``CodeBERTConfig``. ``seed`` initialises the
    parameters (normal(0.02) tables, lecun-normal FFN and xavier attention
    kernels, as the flax initialisers; equal in distribution, not bit for
    bit); ``seed=None`` leaves them uninitialised for a state dict."""

    def __init__(self, vocab_size: int = 50265, d_model: int = 768,
                 num_layers: int = 12, num_heads: int = 12,
                 dim_feedforward: int = 3072, max_positions: int = 514,
                 compute_dtype: str = "float32", seed: Optional[int] = 0):
        super().__init__()
        self.config = CodeBERTConfig(vocab_size, d_model, num_layers,
                                     num_heads, dim_feedforward,
                                     max_positions, compute_dtype)
        self.num_layers = num_layers
        dt = _DTYPES[compute_dtype]
        self.embeddings = RobertaEmbeddings(vocab_size, d_model,
                                            max_positions, dt)
        for i in range(num_layers):
            self.add_module(f"layer_{i}", RobertaLayer(
                d_model, num_heads, dim_feedforward, dt))
        if seed is not None:
            self.init_params(torch.Generator().manual_seed(seed))

    @classmethod
    def from_config(cls, config: CodeBERTConfig,
                    seed: Optional[int] = 0) -> "FlaxCodeBERT":
        return cls(config.vocab_size, config.d_model, config.num_layers,
                   config.num_heads, config.dim_feedforward,
                   config.max_positions, config.compute_dtype, seed=seed)

    def init_params(self, generator: torch.Generator) -> None:
        for m in self.modules():
            if m is not self and hasattr(m, "init_params"):
                m.init_params(generator)

    def forward(self, input_ids, attention_mask=None):
        """(B, S) ids and 0/1 mask → (B, S, d) f32 embeddings."""
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        x = self.embeddings(input_ids, attention_mask)
        kp = attention_mask.bool()
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, key_padding_mask=kp)
        return x


def load_codebert_params(model: FlaxCodeBERT,
                         model_name: str = "microsoft/codebert-base",
                         seed: int = 0) -> Dict[str, torch.Tensor]:
    """CodeBERT's state dict for ``model``'s shapes: real HF weights when a
    cached copy loads without the network, else a deterministic random
    initialisation from ``seed``."""
    try:
        hf = _load_hf_state_dict(model_name)
    except Exception:
        hf = None
    if hf is None:
        return FlaxCodeBERT.from_config(model.config, seed=seed).state_dict()
    return _convert_hf_weights(hf, model.num_layers)


def _load_hf_state_dict(model_name: str) -> Dict[str, np.ndarray]:
    from transformers import AutoModel
    hf_model = AutoModel.from_pretrained(model_name, local_files_only=True)
    return {k: v.detach().cpu().numpy()
            for k, v in hf_model.state_dict().items()}


def _convert_hf_weights(hf: Mapping[str, np.ndarray],
                        num_layers: int) -> Dict[str, torch.Tensor]:
    """Map an HF RoBERTa state dict (numpy) onto the port's names. torch's
    Linear and the port's Dense share the (out, in) layout, so nothing is
    transposed."""
    names = {
        "embeddings.word_embeddings.weight":
            "embeddings.word_embeddings.weight",
        "embeddings.position_embeddings.weight":
            "embeddings.position_embeddings.weight",
        "embeddings.token_type_embeddings.weight":
            "embeddings.token_type_embeddings.weight",
        "embeddings.layer_norm.weight": "embeddings.LayerNorm.weight",
        "embeddings.layer_norm.bias": "embeddings.LayerNorm.bias",
    }
    per_layer = {
        "attention.q_proj": "attention.self.query",
        "attention.k_proj": "attention.self.key",
        "attention.v_proj": "attention.self.value",
        "attention.out_proj": "attention.output.dense",
        "attention_norm": "attention.output.LayerNorm",
        "intermediate": "intermediate.dense",
        "output": "output.dense",
        "output_norm": "output.LayerNorm",
    }
    for i in range(num_layers):
        for ours, theirs in per_layer.items():
            for leaf in ("weight", "bias"):
                names[f"layer_{i}.{ours}.{leaf}"] = \
                    f"encoder.layer.{i}.{theirs}.{leaf}"
    return {ours: torch.tensor(np.asarray(hf[theirs], np.float32))
            for ours, theirs in names.items()}
