"""Configuration of the port: the JAX package's ``config.py``, kept as its own copy.

``ModelConfig``, ``TrainConfig`` and ``DataConfig`` carry the same fields and
defaults as ``sct_gan_tpu/config.py``, so a configuration built by either
package converts to the other with ``dataclasses.asdict``. Fields that are
TPU layout or JAX-only knobs (``use_flash_attention``,
``pad_attention_heads``, ``remat``, ``sorted_embed_grad``, ``seq_axis``,
``fast_rng``, ``dp_shards``) are kept for that round trip; the port reads
none of them.

The variant configs (``VariantConfig``, ``sct_gan_config``,
``model_v3_config``, ``TASCConfig``, ``binary_tasc_config``,
``multiclass_tasc_config``) are the JAX package's as well.
``CodeBERTConfig`` is the port's own: the shapes of the frozen CodeBERT
embedder (``variants/codebert.py``), which the JAX package passes as
keyword arguments, so that ``convert.py`` can build that module from a
configuration as it builds the others.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional

VULNERABILITY_TYPES = [
    "ARTHM", "DOS", "LE", "RENT", "TimeM", "TimeO", "Tx-Origin", "UE",
]


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters (reference: SCT-GAN/model.py:24-36)."""

    d_model: int = 768
    nhead: int = 8
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    dim_feedforward: int = 2048
    dropout: float = 0.3
    max_length: int = 1024
    max_lines: int = 1024          # static line-slot count (ref pads to 1024)
    vocab_size: int = 50265
    num_vulnerability_types: int = 8
    use_gan: bool = False
    compute_dtype: str = "bfloat16"   # matmul/activation dtype; params f32
    use_flash_attention: bool = True
    pad_attention_heads: bool = True
    remat: bool = False
    # vocab-sized parameters (embedding tables, LM head) are padded up to a
    # multiple of this; exposed logits are sliced back to vocab_size and the
    # fused LM-CE masks the pad columns out of its logsumexp
    vocab_pad_multiple: int = 128
    sorted_embed_grad: bool = False
    seq_axis: Optional[str] = None

    @property
    def padded_vocab_size(self) -> int:
        m = max(int(self.vocab_pad_multiple), 1)
        return (self.vocab_size + m - 1) // m * m

    # True = each batch row masks its own line count; False (default) =
    # reference parity: the line count is global across the batch
    per_sample_line_counts: bool = False


@dataclass(frozen=True)
class DataConfig:
    """Data pipeline config (reference: SCT-GAN/dataset.py:102-109, 275-332)."""

    data_path: str = ""
    tokenizer_name: str = "microsoft/codebert-base"
    max_length: int = 1024
    batch_size: int = 8
    vulnerability_types: tuple = tuple(VULNERABILITY_TYPES)
    split_seed: int = 42
    train_frac: float = 0.8


@dataclass(frozen=True)
class TrainConfig:
    """Trainer config (reference: SCT-GAN/train.py:481-494, 530-540)."""

    learning_rate: float = 1e-6
    weight_decay: float = 0.1
    max_grad_norm: float = 1.0
    adam_b1: float = 0.9
    adam_b2: float = 0.98
    adam_eps: float = 1e-9
    # LR multipliers per parameter group (train.py:530-538)
    contract_head_lr_mult: float = 2.0
    line_head_lr_mult: float = 3.0
    discriminator_lr_mult: float = 0.5
    # ReduceLROnPlateau (train.py:543-550)
    plateau_factor: float = 0.3
    plateau_patience: int = 5
    plateau_min_lr: float = 1e-6
    patience: int = 24                 # early stopping (train.py:582)
    warmup_epochs: int = 5             # line-vuln weight warm-up (train.py:671)
    use_augmentation: bool = False
    use_gan: bool = False
    num_epochs: int = 400
    checkpoint_dir: str = "checkpoints"
    latest_every: int = 1
    line_lr_max: Optional[float] = None
    # the single-pass fused optimizer (train/optimizer.py::FusedOptimizer);
    # False takes the unfused chain (GradientTransform)
    fused_optimizer: bool = True
    # LM head + mean token CE as one autograd op (ops/fused_ce.py)
    fused_lm_ce: bool = True
    aug_bank_size: int = 6
    model_select: str = "gen_loss"
    aug_label_correct: bool = True
    seed: int = 0
    dp_shards: int = 1
    fast_rng: bool = False


@dataclass(frozen=True)
class VariantConfig:
    """A fully-assembled variant = model + data + train configs."""

    name: str = "sct-gan"
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "VariantConfig":
        return cls(
            name=d.get("name", "sct-gan"),
            model=ModelConfig(**d.get("model", {})),
            data=DataConfig(**{k: (tuple(v) if k == "vulnerability_types" else v)
                               for k, v in d.get("data", {}).items()}),
            train=TrainConfig(**d.get("train", {})),
        )


def sct_gan_config(**overrides) -> VariantConfig:
    """Canonical SCT-GAN variant: GAN + augmentation (SCT-GAN/model.py:23)."""
    model = ModelConfig(use_gan=True, **overrides.pop("model", {}))
    train = TrainConfig(use_gan=True, use_augmentation=True,
                        **overrides.pop("train", {}))
    return VariantConfig(name="sct-gan", model=model, train=train, **overrides)


def model_v3_config(**overrides) -> VariantConfig:
    """Model-v3 variant: same architecture, no GAN/aug (Model-v3/model.py)."""
    model = ModelConfig(use_gan=False, **overrides.pop("model", {}))
    train = TrainConfig(use_gan=False, use_augmentation=False,
                        **overrides.pop("train", {}))
    return VariantConfig(name="model-v3", model=model, train=train, **overrides)


@dataclass(frozen=True)
class TASCConfig:
    """Legacy TASC GAN variants (Binary-TASC-model/model.py:261,
    MultiClass-TASC-model/model_code_loc.py:385)."""

    d_model: int = 768
    nhead: int = 8
    num_layers: int = 6
    dim_feedforward: int = 2048
    dropout: float = 0.1
    vocab_size: int = 50265
    decoder_vocab_size: int = 50000
    max_gen_length: int = 512
    multiclass: bool = False
    num_vulnerability_types: int = 4   # multiclass heads
    learning_rate: float = 2e-4        # Adam lr, beta1=0.5 (TASC trainers)
    adam_b1: float = 0.5
    compute_dtype: str = "bfloat16"
    # frozen CodeBERT embedder (RoBERTa-base unless shrunk for tests)
    codebert_num_layers: int = 12
    codebert_nhead: int = 12
    codebert_ffn: int = 3072
    max_length: int = 512


def binary_tasc_config(**overrides) -> TASCConfig:
    return TASCConfig(multiclass=False, **overrides)


def multiclass_tasc_config(**overrides) -> TASCConfig:
    return TASCConfig(multiclass=True, num_vulnerability_types=4, **overrides)


@dataclass(frozen=True)
class CodeBERTConfig:
    """Shapes of the frozen CodeBERT (RoBERTa-base) embedder.

    ``compute_dtype`` is the dtype of its matmuls and attention; the
    parameters stay f32. The JAX trainer runs it in f32; the port's TASC
    trainer gives it the TASC config's compute dtype, because the card's
    attention kernel takes bf16 only."""

    vocab_size: int = 50265
    d_model: int = 768
    num_layers: int = 12
    num_heads: int = 12
    dim_feedforward: int = 3072
    max_positions: int = 514
    compute_dtype: str = "float32"

    @classmethod
    def from_tasc(cls, cfg: TASCConfig) -> "CodeBERTConfig":
        """The embedder a TASC trainer builds for ``cfg``."""
        return cls(vocab_size=cfg.vocab_size, d_model=cfg.d_model,
                   num_layers=cfg.codebert_num_layers,
                   num_heads=cfg.codebert_nhead,
                   dim_feedforward=cfg.codebert_ffn,
                   compute_dtype=cfg.compute_dtype)
