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
(``csrc/``): the flash-attention forward and backward and the
single-query decode attention (each with instances for head dims 64, 96
and 128 and a wide-head route for any multiple of 128 above), and the
hash dropout. A tensor on the CPU runs the kernels' plain PyTorch
versions; a CUDA tensor runs the kernels. ``parallel`` runs the trainer and
the analyzer on dp × mp meshes of ranks and the encode sequence-parallel
(``sp_encode`` / ``sp_detect``), on ``torch.distributed``. This package imports neither
JAX nor the JAX package; the JAX package stays the reference.
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
