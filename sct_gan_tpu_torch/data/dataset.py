"""Host-side dataset pipeline: CSV → tokenized, padded, fixed-shape batches.

The port's copy of ``sct_gan_tpu/data/dataset.py``. It reads the CSV with
the standard ``csv`` module and draws the seed-42 split with numpy, the
same rows in the same order as the JAX package's pandas ``df.sample``.

Behavioral parity with the *notebook-inline* dataset (the authoritative
version: Model-v3/trainning-phase.ipynb cell 5), which extends
SCT-GAN/dataset.py:101-369 with per-contract ``contract_vulnerabilities``
labels (contract label per type = 1 iff that type's ``{vuln}_lines`` list is
non-empty) that the trainer requires (SCT-GAN/train.py:633,902).

All outputs are fixed-shape numpy arrays (seq_len = max_length = 1024 with
truncation/padding exactly as the reference). Batches are plain dicts of
numpy arrays; the trainer owns device placement.
"""
from __future__ import annotations

import ast as _pyast
import csv
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .ast_parser import parse_solidity_to_ast, prepare_code2vec_input

VULNERABILITY_TYPES = [
    "ARTHM", "DOS", "LE", "RENT", "TimeM", "TimeO", "Tx-Origin", "UE",
]


def _parse_vuln_lines(value) -> List[int]:
    """Parse a ``{vuln}_lines`` CSV cell (string repr of a list, or list)."""
    if isinstance(value, str):
        try:
            value = _pyast.literal_eval(value)
        except Exception:
            value = []
    if not isinstance(value, (list, tuple)):
        return []
    return [v for v in value if isinstance(v, int)]


def build_token_to_line(source_code: str, tokenizer, max_length: int) -> np.ndarray:
    """Token→line map built by tokenizing each line separately.

    Parity with SCT-GAN/dataset.py:154-173 (including the deliberate quirk
    that this per-line tokenization differs subtly from whole-text
    tokenization): ``[0] + per-line ids + [0]`` for CLS/SEP, then
    truncate/pad to ``max_length``.
    """
    if hasattr(tokenizer, "encode_with_lines"):
        # native single-pass path (data/native_tokenizer.py): identical
        # per-line semantics, one C++ call instead of O(lines) tokenizations
        _, lines_arr = tokenizer.encode_with_lines(source_code)
        token_to_line = lines_arr.tolist()
    else:
        token_to_line = []
        for current_line, line in enumerate(source_code.split("\n")):
            n = len(tokenizer.encode(line, add_special_tokens=False))
            token_to_line.extend([current_line] * n)
    token_to_line = [0] + token_to_line + [0]
    if len(token_to_line) > max_length:
        token_to_line = token_to_line[:max_length]
    if len(token_to_line) < max_length:
        token_to_line.extend([0] * (max_length - len(token_to_line)))
    return np.asarray(token_to_line, dtype=np.int32)


class SmartContractVulnerabilityDataset:
    """Preprocessed, fully materialized dataset of fixed-shape examples."""

    def __init__(
        self,
        data_path: Optional[str] = None,
        tokenizer=None,
        max_length: int = 1024,
        split: str = "train",
        vulnerability_types: Optional[Sequence[str]] = None,
        records: Optional[List[Dict]] = None,
    ):
        """``records`` bypasses CSV loading with a list of dicts carrying
        ``source_code``, ``contract_name``, and ``{vuln}_lines`` keys —
        used by the synthetic corpus generator and tests."""
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.split = split
        self.vulnerability_types = list(vulnerability_types or VULNERABILITY_TYPES)
        if records is None:
            records = self._load_records(data_path)
        self.data = [self._process_row(r) for r in records]

    # -- loading ----------------------------------------------------------
    def _load_records(self, data_path: str) -> List[Dict]:
        with open(data_path, newline="", encoding="utf-8") as f:
            rows = list(csv.DictReader(f))
        # Reference split quirk (SCT-GAN/dataset.py:136-139): train and val
        # are both drawn from the *same* seed-42 permutation, so the val
        # fraction is a subset of the train fraction. pandas'
        # df.sample(frac, random_state=42) takes the first round(frac * n)
        # entries of RandomState(42).permutation(n); this is that draw.
        frac = 0.8 if self.split == "train" else 0.2
        order = np.random.RandomState(42).permutation(len(rows))
        # an empty CSV cell reads as NaN in pandas: keep that value
        return [{k: (float("nan") if v == "" else v) for k, v in
                 rows[int(i)].items()}
                for i in order[:round(frac * len(rows))]]

    def _process_row(self, row: Dict) -> Dict:
        source_code = row["source_code"]
        # empty CSV cells round-trip through pandas as NaN floats
        if not isinstance(source_code, str):
            source_code = "" if source_code is None or (
                isinstance(source_code, float) and math.isnan(source_code)
            ) else str(source_code)
        contract_name = row.get("contract_name", "Unknown")
        if not isinstance(contract_name, str):
            contract_name = "Unknown"

        ast = parse_solidity_to_ast(source_code)
        ast_paths = prepare_code2vec_input(ast) if ast else []
        ast_path_text = " ".join(ast_paths)

        token_to_line = build_token_to_line(source_code, self.tokenizer,
                                            self.max_length)
        line_labels = self._create_multi_label_line_labels(source_code, row)

        enc = self.tokenizer(source_code, max_length=self.max_length,
                             padding="max_length", truncation=True,
                             return_tensors="np")
        ast_enc = self.tokenizer(ast_path_text, max_length=self.max_length,
                                 padding="max_length", truncation=True,
                                 return_tensors="np")

        # (num_types, max_length) line-indexed labels (dataset.py:196-201)
        vuln = np.zeros((len(self.vulnerability_types), self.max_length),
                        dtype=np.int32)
        for i, labels in enumerate(line_labels):
            labels = labels[: self.max_length]
            vuln[i, : len(labels)] = labels

        # Notebook-authoritative contract-level labels: 1 iff any line of
        # that type is marked (Model-v3/trainning-phase.ipynb cell 5).
        contract_vulns = np.asarray(
            [1 if any(l) else 0 for l in line_labels], dtype=np.int32)

        return {
            "input_ids": np.asarray(enc["input_ids"][0], dtype=np.int32),
            "attention_mask": np.asarray(enc["attention_mask"][0], dtype=np.int32),
            "ast_input_ids": np.asarray(ast_enc["input_ids"][0], dtype=np.int32),
            "ast_attention_mask": np.asarray(ast_enc["attention_mask"][0], dtype=np.int32),
            "vulnerable_lines": vuln,
            "contract_vulnerabilities": contract_vulns,
            "token_to_line": token_to_line,
            "source_code": source_code,
            "contract_name": contract_name,
        }

    def _create_multi_label_line_labels(self, source_code: str,
                                        row: Dict) -> List[List[int]]:
        """Per-type per-line 0/1 labels (SCT-GAN/dataset.py:219-240)."""
        total_lines = len(source_code.split("\n"))
        out: List[List[int]] = []
        for vuln_type in self.vulnerability_types:
            labels = [0] * total_lines
            for line_num in _parse_vuln_lines(row.get(f"{vuln_type}_lines", [])):
                if 0 <= line_num < total_lines:
                    labels[line_num] = 1
            out.append(labels)
        return out

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, idx: int) -> Dict:
        return self.data[idx]


def custom_collate_fn(batch: List[Dict]) -> Dict:
    """Stack a list of examples into a dict of batched numpy arrays.

    Parity with SCT-GAN/dataset.py:248-273 (shapes are already fixed, so
    stacking is trivial; string fields become Python lists)."""
    out: Dict = {}
    for key in ("input_ids", "attention_mask", "ast_input_ids",
                "ast_attention_mask", "vulnerable_lines",
                "contract_vulnerabilities", "token_to_line"):
        out[key] = np.stack([item[key] for item in batch])
    out["source_code"] = [item["source_code"] for item in batch]
    out["contract_name"] = [item["contract_name"] for item in batch]
    return out


class ArrayDataLoader:
    """Minimal host-side loader: shuffled, fixed-batch iteration.

    Replaces the reference's torch DataLoader fork-workers
    (SCT-GAN/dataset.py:315-331) with a zero-copy in-process iterator; the
    dataset is fully materialized so per-step host work is one np.stack.
    """

    def __init__(self, dataset, batch_size: int = 8, shuffle: bool = False,
                 seed: int = 0, drop_last: bool = False,
                 collate_fn=custom_collate_fn):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.collate_fn = collate_fn
        self._epoch = 0
        self._seed = seed

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return math.ceil(n / self.batch_size)

    def __iter__(self) -> Iterator[Dict]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self._seed + self._epoch)
            rng.shuffle(idx)
            self._epoch += 1
        for start in range(0, len(idx), self.batch_size):
            sel = idx[start:start + self.batch_size]
            if self.drop_last and len(sel) < self.batch_size:
                break
            yield self.collate_fn([self.dataset[int(i)] for i in sel])


def create_dataloaders(
    data_path: str,
    tokenizer,
    batch_size: int = 8,
    max_length: int = 1024,
    num_workers: int = 0,  # accepted for API parity; loader is in-process
    vulnerability_types: Optional[Sequence[str]] = None,
) -> Tuple[ArrayDataLoader, ArrayDataLoader]:
    """Create train/val loaders (parity: SCT-GAN/dataset.py:275-333)."""
    train_dataset = SmartContractVulnerabilityDataset(
        data_path=data_path, tokenizer=tokenizer, max_length=max_length,
        split="train", vulnerability_types=vulnerability_types)
    val_dataset = SmartContractVulnerabilityDataset(
        data_path=data_path, tokenizer=tokenizer, max_length=max_length,
        split="val", vulnerability_types=vulnerability_types)
    return (ArrayDataLoader(train_dataset, batch_size, shuffle=True),
            ArrayDataLoader(val_dataset, batch_size, shuffle=False))


def inspect_dataloader(dataloader: ArrayDataLoader, num_batches: int = 1):
    """Print batch shapes and stats (parity: SCT-GAN/dataset.py:335-369)."""
    print(f"\nDataloader has {len(dataloader)} batches")
    print(f"Batch size: {dataloader.batch_size}")
    for batch_idx, batch in enumerate(dataloader):
        if batch_idx >= num_batches:
            break
        print(f"\nBatch {batch_idx + 1}:")
        print(f"Number of samples in batch: {len(batch['input_ids'])}")
        print(f"Input shape: {batch['input_ids'].shape}")
        print(f"Vulnerability labels shape: {batch['vulnerable_lines'].shape}")
        print("\nSample contract names:")
        for name in batch["contract_name"][:2]:
            print(f"- {name}")
        print(f"\nTotal vulnerable lines in batch: {batch['vulnerable_lines'].sum()}")
        print("\nSample source code (first 200 chars):")
        print(batch["source_code"][0][:200] + "...")
        break
