"""Source-level Solidity data augmentation: the JAX package's module, copied.

Counterpart of ``sct_gan_tpu/data/augmentation.py`` (pure host regex code,
kept as the port's own copy). Behavioral parity with SCT-GAN/data_augmentation.py:8-344: ten probabilistic
source transforms composed 2-4 at a time to build (original, variant) training
pairs. Host-side pure Python; the trainer re-tokenizes pairs into fixed-shape
batches.

Differences from the reference: randomness is threaded through an explicit
``random.Random`` instance (reproducible batches, no global-state races when
sharded across data-parallel hosts), and the tokenizer is injected instead of
constructed from a hub name.
"""
from __future__ import annotations

import random
import re
from typing import Dict, List, Optional, Tuple

from .tokenizer import get_tokenizer


class SmartContractAugmenter:
    def __init__(self, tokenizer_name: str = "microsoft/codebert-base",
                 tokenizer=None, seed: Optional[int] = None):
        self.tokenizer = tokenizer if tokenizer is not None else get_tokenizer(tokenizer_name)
        self.rng = random.Random(seed)

        self.transformations = [
            self._change_variable_names,
            self._change_function_names,
            self._change_visibility_modifiers,
            self._change_pragma_version,
            self._add_comments,
            self._change_data_types,
            self._reorder_functions,
            self._add_modifiers,
            self._change_parameter_names,
            self._add_events,
        ]

        self.variable_mappings = {
            "value": ["data", "state", "storage", "amount", "balance", "total"],
            "balance": ["amount", "value", "total", "sum", "funds"],
            "owner": ["admin", "manager", "controller", "authority"],
            "user": ["account", "address", "participant", "member"],
            "token": ["coin", "asset", "currency", "unit"],
            "price": ["cost", "rate", "fee", "amount"],
            "time": ["duration", "period", "interval", "deadline"],
        }
        self.function_mappings = {
            "setValue": ["setData", "setState", "setStorage", "setAmount", "setBalance"],
            "getValue": ["getData", "getState", "getStorage", "getAmount", "getBalance"],
            "transfer": ["send", "move", "dispatch", "forward"],
            "withdraw": ["extract", "pull", "remove", "claim"],
            "deposit": ["add", "put", "store", "save"],
            "mint": ["create", "generate", "produce", "issue"],
            "burn": ["destroy", "remove", "eliminate", "consume"],
        }
        self.visibility_mappings = {
            "public": ["external", "public"],
            "private": ["internal", "private"],
            "internal": ["private", "internal"],
            "external": ["public", "external"],
        }
        self.datatype_mappings = {
            "uint256": ["uint128", "uint64", "uint32"],
            "uint128": ["uint256", "uint64", "uint32"],
            "address": ["address payable", "address"],
            "string": ["bytes", "string"],
            "bool": ["uint8", "bool"],
        }

    # -- word-substitution transforms (reference :65-148, :223-241) --------
    def _substitute(self, code: str, mappings: Dict[str, List[str]],
                    prob: float) -> str:
        for old, choices in mappings.items():
            if self.rng.random() < prob:
                new = self.rng.choice(choices)
                code = re.sub(r"\b" + re.escape(old) + r"\b", new, code)
        return code

    def _change_variable_names(self, code: str) -> str:
        return self._substitute(code, self.variable_mappings, 0.3)

    def _change_function_names(self, code: str) -> str:
        return self._substitute(code, self.function_mappings, 0.4)

    def _change_visibility_modifiers(self, code: str) -> str:
        return self._substitute(code, self.visibility_mappings, 0.2)

    def _change_data_types(self, code: str) -> str:
        return self._substitute(code, self.datatype_mappings, 0.15)

    def _change_parameter_names(self, code: str) -> str:
        param_patterns = {
            "_value": ["_data", "_amount", "_input", "_param"],
            "_address": ["_account", "_user", "_target", "_recipient"],
            "_amount": ["_value", "_quantity", "_sum", "_total"],
            "_owner": ["_admin", "_manager", "_controller"],
        }
        return self._substitute(code, param_patterns, 0.25)

    def _change_pragma_version(self, code: str) -> str:
        major = self.rng.randint(4, 8)
        minor = self.rng.randint(0, 20)
        patch = self.rng.randint(0, 20)
        return re.sub(r"pragma solidity \^?0\.\d+\.\d+",
                      f"pragma solidity ^{major}.{minor}.{patch}", code)

    def _add_comments(self, code: str) -> str:
        comments = [
            "// This function handles the main logic",
            "// Ensure proper validation",
            "// Update state variables",
            "// Check access control",
            "// Emit events for transparency",
            "// Handle edge cases",
            "// Optimize gas usage",
        ]
        out: List[str] = []
        for line in code.split("\n"):
            out.append(line)
            if (self.rng.random() < 0.1 and line.strip()
                    and not line.strip().startswith("//")):
                out.append(self.rng.choice(comments))
        return "\n".join(out)

    def _reorder_functions(self, code: str) -> str:
        m = re.search(r"(contract\s+\w+\s*\{)(.*?)(\})", code, re.DOTALL)
        if not m:
            return code
        start, body, end = m.group(1), m.group(2), m.group(3)
        functions: List[str] = []
        other: List[str] = []
        current: List[str] = []
        in_function = False
        for line in body.split("\n"):
            if re.match(r"\s*function\s+", line):
                if current:
                    functions.append("\n".join(current))
                current = [line]
                in_function = True
            elif in_function:
                current.append(line)
                if line.strip() == "}":
                    in_function = False
            else:
                other.append(line)
        if current:
            functions.append("\n".join(current))
        if len(functions) > 1 and self.rng.random() < 0.3:
            self.rng.shuffle(functions)
        return start + "\n".join(other) + "\n" + "\n".join(functions) + end

    def _add_modifiers(self, code: str) -> str:
        modifiers = ["onlyOwner", "whenNotPaused", "nonReentrant",
                     "validAddress", "positiveAmount"]
        pattern = r"(function\s+\w+\s*\([^)]*\)\s*)(public|private|internal|external)?"

        def repl(match):
            if self.rng.random() < 0.2:
                return (match.group(1) + self.rng.choice(modifiers) + " "
                        + (match.group(2) or ""))
            return match.group(0)

        return re.sub(pattern, repl, code)

    def _add_events(self, code: str) -> str:
        events = [
            "event ValueSet(address indexed user, uint256 value);",
            "event Transfer(address indexed from, address indexed to, uint256 amount);",
            "event OwnershipTransferred(address indexed previousOwner, address indexed newOwner);",
            "event Paused(address indexed account);",
            "event Unpaused(address indexed account);",
        ]
        m = re.search(r"(contract\s+\w+\s*\{)", code)
        if m and self.rng.random() < 0.3:
            return code.replace(m.group(1),
                                m.group(1) + "\n    " + self.rng.choice(events))
        return code

    # -- composition --------------------------------------------------------
    def augment_contract(self, original_contract: str,
                         num_variants: int = 3) -> List[Tuple[str, str]]:
        """Create (input, variant) pairs, 2-4 random transforms per variant
        (parity: data_augmentation.py:264-291)."""
        pairs: List[Tuple[str, str]] = []
        for _ in range(num_variants):
            num_transforms = self.rng.randint(2, 4)
            variant = original_contract
            for transform in self.rng.sample(self.transformations, num_transforms):
                variant = transform(variant)
            if variant.strip() != original_contract.strip():
                pairs.append((original_contract, variant))
        return pairs

    def create_training_batch(self, contracts: List[str],
                              batch_size: int = 4) -> Dict:
        """Tokenized batch of augmented pairs (parity: :293-344)."""
        all_pairs: List[Tuple[str, str]] = []
        for contract in contracts:
            all_pairs.extend(self.augment_contract(contract, num_variants=2))
        if len(all_pairs) > batch_size:
            selected = self.rng.sample(all_pairs, batch_size)
        else:
            selected = all_pairs
        inputs = [p[0] for p in selected]
        targets = [p[1] for p in selected]
        in_enc = self.tokenizer(inputs, max_length=1024, padding="max_length",
                                truncation=True, return_tensors="np")
        tgt_enc = self.tokenizer(targets, max_length=1024, padding="max_length",
                                 truncation=True, return_tensors="np")
        return {
            "input_ids": in_enc["input_ids"],
            "attention_mask": in_enc["attention_mask"],
            "target_ids": tgt_enc["input_ids"],
            "target_attention_mask": tgt_enc["attention_mask"],
        }


_SAMPLE_CONTRACT = """pragma solidity ^0.8.0;

contract SimpleStorage {
    uint256 private value;
    address public owner;

    constructor() {
        owner = msg.sender;
    }

    function setValue(uint256 _value) public {
        value = _value;
    }

    function getValue() public view returns (uint256) {
        return value;
    }
}
"""


def test_augmentation(num_variants: int = 3, verbose: bool = True):
    """Run the augmenter on the embedded sample contract and show the pairs
    (parity: SCT-GAN/data_augmentation.py:346-396)."""
    augmenter = SmartContractAugmenter()
    pairs = augmenter.augment_contract(_SAMPLE_CONTRACT, num_variants)
    if verbose:
        print(f"Generated {len(pairs)} augmented pairs")
        for i, (original, variant) in enumerate(pairs, 1):
            print(f"\n=== Variant {i} ===")
            print(variant[:400])
    return pairs


if __name__ == "__main__":
    test_augmentation()
