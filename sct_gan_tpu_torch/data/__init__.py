"""Host-side data pipeline of the port: copies of the JAX package's modules."""
from .ast_parser import parse_solidity_to_ast, prepare_code2vec_input
from .augmentation import SmartContractAugmenter
from .dataset import (SmartContractVulnerabilityDataset, build_token_to_line,
                      create_dataloaders, custom_collate_fn,
                      inspect_dataloader)
from .pattern_matcher import PatternMatcher
from .synthetic import generate_corpus, write_corpus_csv
from .tasc_dataset import (TASCDataLoader, TASCDataset, load_hf_tasc_records,
                           tasc_collate, tasc_records_from_corpus)
from .tokenizer import SolidityTokenizer, get_tokenizer

__all__ = [
    "parse_solidity_to_ast",
    "prepare_code2vec_input",
    "SmartContractAugmenter",
    "SolidityTokenizer",
    "get_tokenizer",
    "SmartContractVulnerabilityDataset",
    "custom_collate_fn",
    "create_dataloaders",
    "build_token_to_line",
    "inspect_dataloader",
    "generate_corpus",
    "write_corpus_csv",
    "PatternMatcher",
    "TASCDataset",
    "TASCDataLoader",
    "tasc_collate",
    "tasc_records_from_corpus",
    "load_hf_tasc_records",
]
