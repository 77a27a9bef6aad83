"""`analyze_contracts` shim (SCT-GAN/analyze_contracts.py)."""
from ..infer.analyze_contracts import (analyze_custom_contract,
                                       generate_from_template, main)

__all__ = ["main", "analyze_custom_contract", "generate_from_template"]
