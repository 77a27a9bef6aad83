"""`MultiClass-TASC-model` shim: flat layout of model_code_loc.py /
train_code_loc.py / pattern_matcher.py."""
from ..data.pattern_matcher import PatternMatcher
from ..variants.tasc import (CodeDecoder, Discriminator, Generator,
                             SmartContractVulnerabilityGAN,
                             VulnerabilityClassifier,
                             get_vulnerability_explanation)
from ..variants.tasc import TASCEncoder as SmartContractTransformer
from ..variants.tasc_trainer import (SolidityCodeLoss,
                                     VulnerabilityDetectionTrainer)

__all__ = ["SmartContractTransformer", "Generator", "Discriminator",
           "CodeDecoder", "VulnerabilityClassifier",
           "SmartContractVulnerabilityGAN", "get_vulnerability_explanation",
           "PatternMatcher", "SolidityCodeLoss",
           "VulnerabilityDetectionTrainer"]
