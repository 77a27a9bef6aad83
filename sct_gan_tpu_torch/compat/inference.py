"""`inference` shim: flat-module layout of SCT-GAN/inference.py."""
from ..data.ast_parser import parse_solidity_to_ast, prepare_code2vec_input
from ..infer.analyzer import SmartContractAnalyzer

__all__ = ["SmartContractAnalyzer", "parse_solidity_to_ast",
           "prepare_code2vec_input"]
