"""`data_augmentation` shim (SCT-GAN/data_augmentation.py)."""
from ..data.augmentation import SmartContractAugmenter, test_augmentation

__all__ = ["SmartContractAugmenter", "test_augmentation"]
