"""Demo analysis script (parity: SCT-GAN/analyze_contracts.py:19-163);
counterpart of ``sct_gan_tpu/infer/analyze_contracts.py``.

`main()` — init the analyzer from a checkpoint written by the port's
trainer (on the card), detect on a sample contract, generate 2 synthetic
contracts at T=0.8, re-analyze the generated contracts. Plus
`analyze_custom_contract` and `generate_from_template` helpers. Each takes
a prebuilt ``analyzer`` instead of a checkpoint.

    python -m sct_gan_tpu_torch.infer.analyze_contracts
"""
from __future__ import annotations

import json
from typing import Optional

from .analyzer import SmartContractAnalyzer

SAMPLE_CONTRACT = """
pragma solidity ^0.8.0;

contract Example {
    uint256 public value;

    function setValue(uint256 _value) public {
        value = _value;
    }

    function getValue() public view returns (uint256) {
        return value;
    }
}
"""


def main(model_path: str = "checkpoints/best_model",
         analyzer: Optional[SmartContractAnalyzer] = None) -> None:
    print("Initializing SmartContractAnalyzer...")
    analyzer = analyzer or SmartContractAnalyzer(model_path=model_path)
    print("Analyzer initialized successfully!")

    print("\n=== Vulnerability Detection ===")
    vulnerabilities = analyzer.detect_vulnerabilities(SAMPLE_CONTRACT)
    print(json.dumps(vulnerabilities["contract_vulnerabilities"], indent=2))

    print("\n=== Synthetic Contract Generation ===")
    synthetic_contracts = analyzer.generate_synthetic_contract(
        contract_template=SAMPLE_CONTRACT, num_contracts=2, temperature=0.8)
    for i, contract in enumerate(synthetic_contracts, 1):
        print(f"\nContract {i}:\n{contract}")

    print("\n=== Analysis of Generated Contracts ===")
    for i, contract in enumerate(synthetic_contracts, 1):
        print(f"\nAnalyzing Generated Contract {i}:")
        result = analyzer.detect_vulnerabilities(contract)
        print(json.dumps(result["contract_vulnerabilities"], indent=2))


def analyze_custom_contract(contract_code: str,
                            model_path: str = "checkpoints/best_model",
                            analyzer: Optional[SmartContractAnalyzer] = None):
    """Detect vulnerabilities in a custom contract
    (analyze_contracts.py:73-92)."""
    analyzer = analyzer or SmartContractAnalyzer(model_path=model_path)
    vulnerabilities = analyzer.detect_vulnerabilities(contract_code)
    print(json.dumps(vulnerabilities["contract_vulnerabilities"], indent=2))
    return vulnerabilities


def generate_from_template(template_code: str, num_contracts: int = 2,
                           temperature: float = 0.8,
                           model_path: str = "checkpoints/best_model",
                           analyzer: Optional[SmartContractAnalyzer] = None):
    """Generate synthetic contracts from a template
    (analyze_contracts.py:94-131)."""
    analyzer = analyzer or SmartContractAnalyzer(model_path=model_path)
    contracts = analyzer.generate_synthetic_contract(
        contract_template=template_code, num_contracts=num_contracts,
        temperature=temperature)
    for i, contract in enumerate(contracts, 1):
        print(f"\nGenerated Contract {i}:\n{contract}")
    return contracts


if __name__ == "__main__":
    main()
