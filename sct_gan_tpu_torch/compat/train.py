"""`train` shim: flat-module layout of SCT-GAN/train.py."""
from ..losses import (ContractLevelFocalLoss, FocalLoss, SoliditySyntaxLoss,
                      SpatialAwareFocalLoss)
from ..train.trainer import SmartContractTrainer

__all__ = ["SmartContractTrainer", "FocalLoss", "ContractLevelFocalLoss",
           "SpatialAwareFocalLoss", "SoliditySyntaxLoss"]
