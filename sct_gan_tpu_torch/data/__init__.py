"""Host-side data pipeline of the port: copies of the JAX package's modules."""
from .ast_parser import parse_solidity_to_ast, prepare_code2vec_input
from .dataset import (SmartContractVulnerabilityDataset, build_token_to_line,
                      create_dataloaders, custom_collate_fn)
from .synthetic import generate_corpus, write_corpus_csv
from .tokenizer import SolidityTokenizer, get_tokenizer

__all__ = [
    "parse_solidity_to_ast",
    "prepare_code2vec_input",
    "SolidityTokenizer",
    "get_tokenizer",
    "SmartContractVulnerabilityDataset",
    "custom_collate_fn",
    "create_dataloaders",
    "build_token_to_line",
    "generate_corpus",
    "write_corpus_csv",
]
