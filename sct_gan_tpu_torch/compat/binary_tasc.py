"""`Binary-TASC-model` shim: flat layout of its model.py / train.py."""
from ..variants.tasc import (CodeDecoder, Discriminator, Generator,
                             SmartContractVulnerabilityGAN)
from ..variants.tasc import TASCEncoder as SmartContractTransformer
from ..variants.tasc_trainer import (SolidityCodeLoss,
                                     VulnerabilityDetectionTrainer)

__all__ = ["SmartContractTransformer", "Generator", "Discriminator",
           "CodeDecoder", "SmartContractVulnerabilityGAN",
           "SolidityCodeLoss", "VulnerabilityDetectionTrainer"]
