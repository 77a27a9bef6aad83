"""sct_gan_tpu_torch — the PyTorch/CUDA port of ``sct_gan_tpu``.

It covers serving (detection with its fallback tiers, KV-cached sampled
generation and beam search, the diagnostics, from a checkpoint or random
weights), evaluation (``evals``: detection quality, perplexity), training
(the GAN train step with the fused LM-head cross-entropy and the fused
optimizer, the training loop with augmentation, checkpoints and their
restore), the reference's other model families (``variants``: the TASC
GAN, binary and multiclass, with its frozen CodeBERT embedder and trainer;
the variant factory) and the notebooks' import-swap shims (``compat``).
The JAX package's TPU kernels are hand-written in CUDA C++ for Hopper
(``csrc/``): the flash-attention forward and backward (instances for head
dims 64, 96, 128, 192 and 256, and over 256 chunks of the 192 or 256
instance: ``ops.flash_attention.kernel_route``), the single-query decode
attention (instances for 64, 96, 128 and 192, and a wide-head route in
128-column chunks above; both take any multiple of 8 in place:
``ops.decode_attention.decode_route``) and the hash
dropout. A tensor on the CPU runs the kernels' plain PyTorch versions; a
CUDA tensor runs the kernels. ``parallel`` runs the trainer and
the analyzer on dp × mp meshes of ranks and the encode sequence-parallel
(``sp_encode`` / ``sp_detect``), on ``torch.distributed``. This package imports neither
JAX nor the JAX package; the JAX package stays the reference.

The configs, ``VULNERABILITY_TYPES``, ``evaluate_model_performance``,
``create_dataloaders`` and ``get_tokenizer`` load on first access, as in
the JAX package.
"""
from . import parallel
from .convert import convert_flax_opt_state, convert_flax_params
from .infer.analyzer import SmartContractAnalyzer
from .models.sct_transformer import SmartContractTransformer
from .train.trainer import SmartContractTrainer
from .variants import (SmartContractVulnerabilityGAN,
                       VulnerabilityDetectionTrainer, build_trainer,
                       build_variant, generate_vulnerable_code)

__all__ = ["SmartContractAnalyzer", "SmartContractTrainer",
           "SmartContractTransformer", "convert_flax_opt_state",
           "convert_flax_params", "SmartContractVulnerabilityGAN",
           "VulnerabilityDetectionTrainer", "build_variant", "build_trainer",
           "generate_vulnerable_code", "parallel"]

__version__ = "0.1.0"

# Lazy top-level API, the JAX package's names: loaded on first access.
_LAZY = {
    "ModelConfig": ("sct_gan_tpu_torch.config", "ModelConfig"),
    "TrainConfig": ("sct_gan_tpu_torch.config", "TrainConfig"),
    "DataConfig": ("sct_gan_tpu_torch.config", "DataConfig"),
    "TASCConfig": ("sct_gan_tpu_torch.config", "TASCConfig"),
    "VariantConfig": ("sct_gan_tpu_torch.config", "VariantConfig"),
    "sct_gan_config": ("sct_gan_tpu_torch.config", "sct_gan_config"),
    "model_v3_config": ("sct_gan_tpu_torch.config", "model_v3_config"),
    "VULNERABILITY_TYPES": ("sct_gan_tpu_torch.config", "VULNERABILITY_TYPES"),
    "evaluate_model_performance": (
        "sct_gan_tpu_torch.evals", "evaluate_model_performance"),
    "create_dataloaders": ("sct_gan_tpu_torch.data", "create_dataloaders"),
    "get_tokenizer": ("sct_gan_tpu_torch.data", "get_tokenizer"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'sct_gan_tpu_torch' has no attribute "
                         f"{name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
