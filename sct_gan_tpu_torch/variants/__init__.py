"""The reference's model families in PyTorch: the TASC GAN variants with
their frozen CodeBERT embedder and trainer, and the variant factory
(counterpart of ``sct_gan_tpu/variants``)."""
from .codebert import FlaxCodeBERT, load_codebert_params
from .tasc import (CodeDecoder, Discriminator, Generator, PATTERN_HEADS,
                   SmartContractVulnerabilityGAN, TASCEncoder,
                   VulnerabilityClassifier, get_vulnerability_explanation,
                   make_tasc_generate_fn)
from .tasc_trainer import SolidityCodeLoss, VulnerabilityDetectionTrainer
from .factory import (VARIANTS, build_trainer, build_variant,
                      generate_vulnerable_code)

__all__ = [
    "FlaxCodeBERT",
    "load_codebert_params",
    "TASCEncoder",
    "Generator",
    "Discriminator",
    "CodeDecoder",
    "VulnerabilityClassifier",
    "SmartContractVulnerabilityGAN",
    "get_vulnerability_explanation",
    "make_tasc_generate_fn",
    "PATTERN_HEADS",
    "SolidityCodeLoss",
    "VulnerabilityDetectionTrainer",
    "VARIANTS",
    "build_variant",
    "build_trainer",
    "generate_vulnerable_code",
]
