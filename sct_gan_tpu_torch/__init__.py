"""sct_gan_tpu_torch — the PyTorch/CUDA port of ``sct_gan_tpu``.

Two slices: serving (detection and KV-cached generation) and training (the
GAN train step with the fused LM-head cross-entropy and the fused
optimizer). The JAX package's TPU kernels are hand-written in CUDA C++ for
Hopper (``csrc/``): the flash-attention forward and backward, the
single-query decode attention and the hash dropout. A tensor on the CPU
runs the kernels' plain PyTorch versions; a CUDA tensor runs the kernels.
This package imports neither JAX nor the JAX package; the JAX package stays
the reference.
"""
from .convert import convert_flax_opt_state, convert_flax_params
from .infer.analyzer import SmartContractAnalyzer
from .models.sct_transformer import SmartContractTransformer
from .train.trainer import SmartContractTrainer

__all__ = ["SmartContractAnalyzer", "SmartContractTrainer",
           "SmartContractTransformer", "convert_flax_opt_state",
           "convert_flax_params"]
