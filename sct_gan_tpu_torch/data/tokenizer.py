"""Host-side tokenization: the port's copy of ``sct_gan_tpu/data/tokenizer.py``.

The reference uses HF ``microsoft/codebert-base`` (SCT-GAN/dataset.py:376).
This framework delegates to the HF tokenizer when it is available (cached or
reachable), and otherwise falls back to a self-contained, deterministic
``SolidityTokenizer`` with the same API surface that the rest of the framework
needs (``__call__``, ``encode``, ``decode``, ``convert_tokens_to_ids``).

Special-token convention follows the ids the reference's model logic assumes
(SCT-GAN/model.py:864,923: BOS=1 generation start, EOS=2 / PAD=0 stop):
    pad=0, bos=1, eos=2, unk=3.

Tokenization is regex pre-tokenization (identifiers / numbers / strings /
multi-char operators / punctuation) with a frequency-trained vocab and a
deterministic CRC32-hash bucket fallback for out-of-vocab tokens, so encoding
is stable across processes without any network access.
"""
from __future__ import annotations

import json
import re
import zlib
from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Union

import numpy as np

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
UNK_ID = 3
_NUM_SPECIAL = 4

_SPECIAL_TOKENS = {"<pad>": PAD_ID, "<s>": BOS_ID, "</s>": EOS_ID, "<unk>": UNK_ID}

# Stable base vocabulary: Solidity keywords, types, and punctuation get fixed
# ids so syntax-aware losses (losses/syntax.py) see consistent ids across runs.
_BASE_TOKENS = [
    ";", "(", ")", "{", "}", "[", "]", ",", ".", ":", "=", "+", "-", "*", "/",
    "%", "<", ">", "!", "&", "|", "^", "~", "?", "==", "!=", "<=", ">=", "&&",
    "||", "+=", "-=", "*=", "/=", "=>", "->", "**", "++", "--", "<<", ">>",
    "pragma", "solidity", "contract", "interface", "library", "is", "function",
    "modifier", "event", "struct", "enum", "mapping", "public", "private",
    "internal", "external", "view", "pure", "payable", "constant", "immutable",
    "returns", "return", "if", "else", "for", "while", "do", "break",
    "continue", "throw", "emit", "new", "delete", "require", "assert",
    "revert", "import", "using", "memory", "storage", "calldata", "constructor",
    "fallback", "receive", "uint", "uint8", "uint16", "uint32", "uint64",
    "uint128", "uint256", "int", "int256", "address", "bool", "string",
    "bytes", "bytes32", "true", "false", "msg", "sender", "value", "block",
    "timestamp", "number", "now", "this", "super", "owner", "balance",
    "transfer", "send", "call", "delegatecall", "selfdestruct", "keccak256",
    "abi", "indexed", "anonymous", "virtual", "override", "abstract",
    '"', "'", "\n",
]

_PRETOKEN_RE = re.compile(
    r"""
      "(?:[^"\\]|\\.)*"          # double-quoted string
    | '(?:[^'\\]|\\.)*'          # single-quoted string
    | 0[xX][0-9a-fA-F]+          # hex literal
    | \d+\.\d+                   # decimal
    | \d+                        # integer
    | [A-Za-z_$][A-Za-z0-9_$]*   # identifier / keyword
    | ==|!=|<=|>=|&&|\|\||\+=|-=|\*=|/=|=>|->|\*\*|\+\+|--|<<|>>
    | [^\sA-Za-z0-9_$]           # single punctuation
    """,
    re.VERBOSE,
)


class SolidityTokenizer:
    """Deterministic, self-contained code tokenizer with an HF-like API."""

    def __init__(self, vocab: Optional[Dict[str, int]] = None,
                 vocab_size: int = 50265,
                 name_or_path: str = "sct-gan-tpu/solidity-tokenizer"):
        self.vocab_size = vocab_size
        self.name_or_path = name_or_path
        self.pad_token_id = PAD_ID
        self.bos_token_id = BOS_ID
        self.eos_token_id = EOS_ID
        self.unk_token_id = UNK_ID
        self.vocab: Dict[str, int] = dict(_SPECIAL_TOKENS)
        next_id = _NUM_SPECIAL
        for tok in _BASE_TOKENS:
            if tok not in self.vocab:
                self.vocab[tok] = next_id
                next_id += 1
        self._first_free_id = next_id
        if vocab:
            for tok, tid in vocab.items():
                self.vocab.setdefault(tok, tid)
        self._inv: Dict[int, str] = {i: t for t, i in self.vocab.items()}

    # -- vocab construction -------------------------------------------------
    def train_from_texts(self, texts: Iterable[str],
                         max_tokens: Optional[int] = None) -> None:
        """Assign the most frequent pre-tokens stable dense ids."""
        counts: Counter = Counter()
        for text in texts:
            counts.update(_PRETOKEN_RE.findall(text))
        budget = (max_tokens if max_tokens is not None
                  else self.vocab_size - self._first_free_id)
        next_id = self._first_free_id
        for tok, _ in counts.most_common():
            if budget <= 0 or next_id >= self.vocab_size:
                break
            if tok not in self.vocab:
                self.vocab[tok] = next_id
                self._inv[next_id] = tok
                next_id += 1
                budget -= 1
        self._first_free_id = next_id

    def _hash_id(self, token: str) -> int:
        """Deterministic OOV bucket in [first_free, vocab_size)."""
        span = self.vocab_size - self._first_free_id
        if span <= 0:
            return UNK_ID
        h = zlib.crc32(token.encode("utf-8"))
        return self._first_free_id + (h % span)

    # -- core encode/decode --------------------------------------------------
    def tokenize(self, text: str) -> List[str]:
        return _PRETOKEN_RE.findall(text)

    def convert_tokens_to_ids(self, token: Union[str, Sequence[str]]):
        if isinstance(token, str):
            tid = self.vocab.get(token)
            if tid is None:
                tid = self._hash_id(token)
                self._inv.setdefault(tid, token)
            return tid
        return [self.convert_tokens_to_ids(t) for t in token]

    def encode(self, text: str, add_special_tokens: bool = True,
               max_length: Optional[int] = None,
               truncation: bool = False) -> List[int]:
        ids = [self.convert_tokens_to_ids(t) for t in self.tokenize(text)]
        if add_special_tokens:
            ids = [BOS_ID] + ids + [EOS_ID]
        if truncation and max_length is not None and len(ids) > max_length:
            ids = ids[:max_length]
            if add_special_tokens:
                ids[-1] = EOS_ID
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        out: List[str] = []
        for i in np.asarray(ids).reshape(-1).tolist():
            if skip_special_tokens and i in (PAD_ID, BOS_ID, EOS_ID):
                continue
            out.append(self._inv.get(int(i), "<unk>"))
        # re-join with spaces except around tight punctuation
        text = ""
        for tok in out:
            if tok in {";", ",", ")", "]", "}", "."} or not text:
                text += tok
            elif text.endswith(("(", "[", "{", ".")):
                text += tok
            else:
                text += " " + tok
        return text

    # -- HF-style batched call ------------------------------------------------
    def __call__(self, text: Union[str, List[str]],
                 max_length: Optional[int] = None,
                 padding: Union[bool, str] = False,
                 truncation: bool = False,
                 return_tensors: Optional[str] = "np",
                 add_special_tokens: bool = True):
        texts = [text] if isinstance(text, str) else list(text)
        seqs = [self.encode(t, add_special_tokens=add_special_tokens,
                            max_length=max_length, truncation=truncation)
                for t in texts]
        if padding == "max_length" and max_length is not None:
            target = max_length
        elif padding:
            target = max(len(s) for s in seqs)
        else:
            target = None
        input_ids, attn = [], []
        for s in seqs:
            if target is not None:
                mask = [1] * len(s) + [0] * (target - len(s))
                s = s + [PAD_ID] * (target - len(s))
            else:
                mask = [1] * len(s)
            input_ids.append(s)
            attn.append(mask)
        out = {"input_ids": np.asarray(input_ids, dtype=np.int32),
               "attention_mask": np.asarray(attn, dtype=np.int32)}
        if return_tensors == "pt":
            # HF-API compat: callers written against the reference pipeline
            # (e.g. its dataset/collate, SCT-GAN/dataset.py:176-253) expect
            # torch tensors with .size()/.squeeze()
            import torch
            out = {k: torch.from_numpy(v.astype(np.int64)) for k, v in
                   out.items()}
        return out

    # -- persistence -----------------------------------------------------------
    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"vocab_size": self.vocab_size, "vocab": self.vocab}, f)

    @classmethod
    def load(cls, path: str) -> "SolidityTokenizer":
        with open(path) as f:
            blob = json.load(f)
        tok = cls(vocab_size=blob["vocab_size"])
        for t, i in blob["vocab"].items():
            tok.vocab[t] = i
            tok._inv[i] = t
        tok._first_free_id = max(
            tok._first_free_id,
            1 + max((i for i in blob["vocab"].values()
                     if i < blob["vocab_size"]), default=0))
        return tok


def get_tokenizer(name: str = "microsoft/codebert-base",
                  prefer_hf: bool = True):
    """Return an HF tokenizer when available, else the hermetic fallback.

    Mirrors the reference's single entry point (SCT-GAN/dataset.py:376) while
    staying functional with zero network access.
    """
    if prefer_hf:
        try:
            from transformers import AutoTokenizer
            return AutoTokenizer.from_pretrained(name)
        except Exception:
            pass
    # native C++ encode path (exact-id parity with SolidityTokenizer,
    # data/native_tokenizer.py) — transparently degrades to pure Python
    # when the toolchain is unavailable
    try:
        from .native_tokenizer import NativeSolidityTokenizer
        return NativeSolidityTokenizer(name_or_path=name)
    except Exception:
        return SolidityTokenizer(name_or_path=name)
