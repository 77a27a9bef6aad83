"""`dataset` shim: flat-module layout of SCT-GAN/dataset.py."""
from ..data.ast_parser import parse_solidity_to_ast, prepare_code2vec_input
from ..data.dataset import (ArrayDataLoader, SmartContractVulnerabilityDataset,
                            build_token_to_line, create_dataloaders,
                            custom_collate_fn, inspect_dataloader)

__all__ = ["parse_solidity_to_ast", "prepare_code2vec_input",
           "SmartContractVulnerabilityDataset", "custom_collate_fn",
           "create_dataloaders", "inspect_dataloader", "ArrayDataLoader",
           "build_token_to_line"]
