"""Native-accelerated SolidityTokenizer: the port's copy of
``sct_gan_tpu/data/native_tokenizer.py``, built from the port's own
``native/fast_tokenizer.cpp``.

Same vocabulary, ids, and API as the pure-Python `SolidityTokenizer` — the
pretokenization scan, vocab lookup, and CRC32 OOV bucketing run in C++
(native/fast_tokenizer.cpp) via ctypes. Adds `encode_with_lines`, which
returns (ids, line_index_per_token) in ONE pass with the reference's
per-line tokenization semantics — collapsing the dataset pipeline's
O(num_lines) tokenizer calls (SCT-GAN/dataset.py:154-173) into a single
native call. Falls back to the Python implementation transparently when the
toolchain is unavailable.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np

from ..native.build import load_library
from .tokenizer import SolidityTokenizer

_MAX_TOKENS = 1 << 18


class NativeSolidityTokenizer(SolidityTokenizer):
    """SolidityTokenizer with C++ encode paths (exact-id parity)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._native = None
        self._handle = None
        lib = load_library()
        if lib is not None:
            handle = lib.ft_create(self.vocab_size, self._first_free_id)
            for tok, tid in self.vocab.items():
                if tid < self.vocab_size:
                    lib.ft_add_token(handle, tok.encode("utf-8"), tid)
            self._native = lib
            self._handle = handle
        self._ids_buf = (ctypes.c_int32 * _MAX_TOKENS)()
        self._lines_buf = (ctypes.c_int32 * _MAX_TOKENS)()

    @property
    def native_active(self) -> bool:
        return self._native is not None

    def _encode_raw(self, text: str) -> List[int]:
        if self._native is None:
            return [self.convert_tokens_to_ids(t) for t in self.tokenize(text)]
        data = text.encode("utf-8", errors="replace")
        n = self._native.ft_encode(self._handle, data, len(data),
                                   self._ids_buf, _MAX_TOKENS)
        return list(self._ids_buf[:n])

    def encode(self, text: str, add_special_tokens: bool = True,
               max_length: Optional[int] = None,
               truncation: bool = False) -> List[int]:
        ids = self._encode_raw(text)
        if add_special_tokens:
            ids = [self.bos_token_id] + ids + [self.eos_token_id]
        if truncation and max_length is not None and len(ids) > max_length:
            ids = ids[:max_length]
            if add_special_tokens:
                ids[-1] = self.eos_token_id
        return ids

    def encode_with_lines(self, text: str
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """(token_ids, line_index_per_token), per-line tokenization
        semantics, no special tokens — one native pass."""
        if self._native is None:
            ids: List[int] = []
            lines: List[int] = []
            for li, line in enumerate(text.split("\n")):
                line_ids = self._encode_raw(line)
                ids.extend(line_ids)
                lines.extend([li] * len(line_ids))
            return (np.asarray(ids, np.int32), np.asarray(lines, np.int32))
        data = text.encode("utf-8", errors="replace")
        n = self._native.ft_encode_lines(self._handle, data, len(data),
                                         self._ids_buf, self._lines_buf,
                                         _MAX_TOKENS)
        return (np.asarray(self._ids_buf[:n], np.int32),
                np.asarray(self._lines_buf[:n], np.int32))

    def __del__(self):
        if self._native is not None and self._handle is not None:
            try:
                self._native.ft_destroy(self._handle)
            except Exception:
                pass
