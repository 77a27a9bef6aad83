"""Serving: the analyzer and the generation loops."""
from .analyzer import SmartContractAnalyzer
from .generate import make_beam_search_fn, make_generate_fn

__all__ = [
    "SmartContractAnalyzer",
    "make_beam_search_fn",
    "make_generate_fn",
]
