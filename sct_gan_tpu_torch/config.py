"""Configuration of the port: the JAX package's ``config.py``, kept as its own copy.

``ModelConfig``, ``TrainConfig`` and ``DataConfig`` carry the same fields and
defaults as ``sct_gan_tpu/config.py``, so a configuration built by either
package converts to the other with ``dataclasses.asdict``. Fields that are
TPU layout or JAX-only knobs (``use_flash_attention``,
``pad_attention_heads``, ``remat``, ``sorted_embed_grad``, ``seq_axis``,
``fast_rng``, ``dp_shards``) are kept for that round trip; the port reads
none of them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

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
    # the port has no other optimizer path
    fused_optimizer: bool = True
    # LM head + mean token CE as one autograd op (ops/fused_ce.py)
    fused_lm_ce: bool = True
    aug_bank_size: int = 6
    model_select: str = "gen_loss"
    aug_label_correct: bool = True
    seed: int = 0
    dp_shards: int = 1
    fast_rng: bool = False
