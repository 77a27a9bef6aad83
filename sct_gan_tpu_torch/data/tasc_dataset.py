"""Dataset pipeline for the legacy TASC variants.

The port's copy of ``sct_gan_tpu/data/tasc_dataset.py``: batches are dicts
of numpy arrays; the trainer moves them to its device.

The reference loads HF `jainabh/smart_contracts_malicious` with binary
malicious labels and builds dual streams — contract tokens + code2vec AST
paths (Binary-TASC-model/main.ipynb cells 3-6). This module produces the
same batch contract from any record source (HF dataset when cached, CSV, or
the synthetic corpus), hermetically:

    input_ids / attention_mask            contract token stream
    path_input_ids / path_attention_mask  AST-path token stream
    label                                 binary malicious flag
    vulnerability_labels                  (multiclass) per-type 0/1 vector
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from .ast_parser import parse_solidity_to_ast, prepare_code2vec_input

MULTICLASS_TYPES = ["timestamp_dependence", "reentrancy", "integer_overflow",
                    "dangerous_delegatecall"]


class TASCDataset:
    """Fixed-shape TASC examples from records with `source_code` +
    `malicious` (or per-type) labels."""

    def __init__(self, records: List[Dict], tokenizer, max_length: int = 512,
                 multiclass: bool = False,
                 num_vulnerability_types: int = 4):
        self.tokenizer = tokenizer
        self.max_length = max_length
        self.multiclass = multiclass
        self.num_types = num_vulnerability_types
        self.data = [self._process(r) for r in records]

    def _process(self, row: Dict) -> Dict:
        code = row["source_code"]
        ast = parse_solidity_to_ast(code)
        paths = " ".join(prepare_code2vec_input(ast)) if ast else ""
        enc = self.tokenizer(code, max_length=self.max_length,
                             padding="max_length", truncation=True,
                             return_tensors="np")
        penc = self.tokenizer(paths, max_length=self.max_length,
                              padding="max_length", truncation=True,
                              return_tensors="np")
        label = int(row.get("malicious", row.get("label", 0)))
        item = {
            "input_ids": np.asarray(enc["input_ids"][0], np.int32),
            "attention_mask": np.asarray(enc["attention_mask"][0], np.int32),
            "path_input_ids": np.asarray(penc["input_ids"][0], np.int32),
            "path_attention_mask": np.asarray(penc["attention_mask"][0],
                                              np.int32),
            "label": np.float32(label),
            "source_code": code,
        }
        if self.multiclass:
            vl = np.zeros((self.num_types,), np.float32)
            for i, name in enumerate(MULTICLASS_TYPES[: self.num_types]):
                vl[i] = float(row.get(name, 0))
            item["vulnerability_labels"] = vl
        return item

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        return self.data[idx]


def tasc_collate(batch: List[Dict]) -> Dict:
    out: Dict = {}
    for key in batch[0]:
        if key == "source_code":
            out[key] = [b[key] for b in batch]
        else:
            out[key] = np.stack([b[key] for b in batch])
    return out


class TASCDataLoader:
    def __init__(self, dataset: TASCDataset, batch_size: int = 4,
                 shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._seed = seed
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        return (n // self.batch_size if self.drop_last
                else math.ceil(n / self.batch_size))

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
            yield tasc_collate([self.dataset[int(i)] for i in sel])


def load_hf_tasc_records(name: str = "jainabh/smart_contracts_malicious",
                         split: str = "train",
                         max_records: Optional[int] = None) -> List[Dict]:
    """Load the reference's TASC dataset from HF datasets
    (Binary-TASC-model/main.ipynb cell 3) when it is cached locally; raises
    with a clear message offline (use `tasc_records_from_corpus` instead)."""
    from datasets import load_dataset
    ds = load_dataset(name, split=split)
    out: List[Dict] = []
    for i, row in enumerate(ds):
        if max_records is not None and i >= max_records:
            break
        # the reference notebook reads ds['train'][...]['contract_source']
        # (Binary-TASC-model/main.ipynb cell 6) — try that column first
        code = (row.get("contract_source") or row.get("source_code")
                or row.get("code") or row.get("text"))
        label = row.get("malicious", row.get("label", 0))
        if code:
            out.append({"source_code": code, "malicious": int(label)})
    return out


def tasc_records_from_corpus(n: int = 16, seed: int = 0,
                             multiclass: bool = False) -> List[Dict]:
    """Synthetic TASC records: the framework's contract generator plus
    malicious flags derived from the embedded vulnerability labels."""
    from .synthetic import generate_corpus
    from .pattern_matcher import PatternMatcher
    records = generate_corpus(n=n, seed=seed)
    pm = PatternMatcher() if multiclass else None
    out = []
    for r in records:
        vuln_lines = sum(len(r.get(f"{t}_lines", []) or [])
                         for t in ("ARTHM", "DOS", "LE", "RENT", "TimeM",
                                   "TimeO", "Tx-Origin", "UE"))
        row = {"source_code": r["source_code"],
               "malicious": 1 if vuln_lines > 0 else 0}
        if multiclass:
            scores = pm.get_pattern_scores(r["source_code"])
            for name in MULTICLASS_TYPES:
                row[name] = 1 if max(scores[name].values(), default=0) > 0 \
                    else 0
        out.append(row)
    return out
