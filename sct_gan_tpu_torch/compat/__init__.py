"""Import-swap compatibility shims for reference notebooks (the port's
counterpart of ``sct_gan_tpu/compat``).

The reference's notebooks import flat modules (`import model`,
`from train import SmartContractTrainer`, `from dataset import
create_dataloaders`, `from inference import SmartContractAnalyzer`, ...).
These shims reproduce that flat-module layout so a reference notebook runs
with only the import root swapped:

    from sct_gan_tpu_torch.compat import model, train, dataset, inference
    from sct_gan_tpu_torch.compat import data_augmentation, pattern_matcher
    from sct_gan_tpu_torch.compat import notebook_utils, analyze_contracts
"""
from . import (analyze_contracts, binary_tasc, data_augmentation, dataset,
               inference, model, multiclass_tasc, notebook_utils,
               pattern_matcher, train)

__all__ = ["model", "train", "dataset", "inference", "data_augmentation",
           "pattern_matcher", "notebook_utils", "analyze_contracts",
           "binary_tasc", "multiclass_tasc"]
