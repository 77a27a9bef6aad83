"""SmartContractAnalyzer — the serving engine of the port.

Counterpart of ``sct_gan_tpu/infer/analyzer.py`` for the serving slice:
loading a checkpoint written by the port's trainer (``model_path``),
``detect_vulnerabilities``, batched ``analyze_multiple_contracts``,
``get_vulnerability_summary``, ``generate_synthetic_contract`` (sampling
mode) and ``generate_template_based_contract``. The three-tier
``*_with_fallback`` / ``*_safe`` APIs, beam search and the diagnostics wait
for a later slice.

Errors propagate: the only fallback kept is the JAX analyzer's empty-decode
one (a generated sequence that decodes to almost nothing is replaced by the
template transform). A CUDA or kernel error is never swallowed.
"""
from __future__ import annotations

import os
import random
import re
from typing import Any, Dict, List, Mapping, Optional, Union

import numpy as np
import torch

from ..config import VULNERABILITY_TYPES, ModelConfig
from ..convert import convert_flax_params, flax_tree_from_npz
from ..data.ast_parser import parse_solidity_to_ast, prepare_code2vec_input
from ..data.dataset import build_token_to_line
from ..data.tokenizer import get_tokenizer
from ..models.sct_transformer import SmartContractTransformer
from ..train.checkpoint import adapt_vocab_params, load_checkpoint
from ..utils import resolve_device
from .generate import make_generate_fn, syntax_boost_ids


class SmartContractAnalyzer:
    """Analyze contracts for vulnerabilities and generate new ones.

    ``model_path``: a checkpoint directory written by the port's trainer
    (``train/checkpoint.py``), a wrapped train state or raw params; its
    vocab-sized leaves are adapted to ``padded_vocab_size``. A path that
    does not exist raises. ``params``: a state dict of the port (e.g. from
    ``convert_flax_params``), or the path of an ``.npz`` holding a
    flattened flax tree (``/``-joined keys). With neither, the weights are
    initialised from ``seed``. ``device``: where the model runs, the card
    (``"cuda"``) by default; without one the constructor raises unless
    ``device="cpu"`` is passed. A CUDA device runs the hand-written
    kernels, the CPU their plain versions.
    """

    def __init__(self, model_path: Optional[str] = None,
                 tokenizer_name: str = "microsoft/codebert-base",
                 device: Union[str, torch.device] = "cuda",
                 use_gan: bool = True,
                 model_config: Optional[ModelConfig] = None,
                 params: Optional[Union[str, Mapping[str, Any]]] = None,
                 tokenizer=None, batch_size: int = 8, verbose: bool = True,
                 line_fusion: bool = True, seed: int = 0):
        self._log = print if verbose else (lambda *a, **k: None)
        if model_path is not None and not os.path.isdir(model_path):
            raise FileNotFoundError(f"model_path {model_path!r}: no "
                                    f"checkpoint directory there")
        # contract probability fused with the line heads (max over the
        # informative lines); False = head-only, reference parity
        self.line_fusion = line_fusion
        self.tokenizer = tokenizer or get_tokenizer(tokenizer_name)
        self.vulnerability_types = list(VULNERABILITY_TYPES)
        self.batch_size = batch_size
        self.device = resolve_device(device)

        cfg = model_config or ModelConfig(
            dropout=0.1, vocab_size=int(self.tokenizer.vocab_size),
            use_gan=use_gan)
        self.config = cfg
        self.max_length = cfg.max_length
        if params is None and model_path is not None:
            tree, meta = load_checkpoint(model_path)
            # wrapped train state or raw params (inference.py:47-58)
            flax = tree["params"] if "params" in tree else tree
            params = convert_flax_params(
                adapt_vocab_params(flax, cfg.padded_vocab_size), cfg)
            self._log(f"Model loaded from {model_path}")
            if meta:
                self._log(f"Training epoch: {meta.get('epoch', 'Unknown')}")
                self._log(f"Best validation loss: "
                          f"{meta.get('val_loss', 'Unknown')}")
        if params is None:
            self.model = SmartContractTransformer(cfg, seed=seed)
            self._log("Initialized random parameters (no checkpoint)")
        else:
            if isinstance(params, str):
                params = convert_flax_params(flax_tree_from_npz(params), cfg)
            self.model = SmartContractTransformer(cfg, seed=None)
            self.model.load_state_dict(params)
        self.model.eval().to(self.device).cast_dense_weights_()

        self.syntax_ids = syntax_boost_ids(self.tokenizer)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._generate_fn = make_generate_fn(self.model, self.syntax_ids)
        self.last_decode_steps = 0   # decode steps of the last generation

    # -- input preparation ---------------------------------------------------
    def _prepare_inputs(self, codes: List[str]) -> Dict[str, torch.Tensor]:
        asts = [parse_solidity_to_ast(c) for c in codes]
        path_texts = [" ".join(prepare_code2vec_input(a)) if a else ""
                      for a in asts]
        enc = self.tokenizer(codes, max_length=self.max_length,
                             padding="max_length", truncation=True,
                             return_tensors="np")
        ast_enc = self.tokenizer(path_texts, max_length=self.max_length,
                                 padding="max_length", truncation=True,
                                 return_tensors="np")
        ttl = np.stack([build_token_to_line(c, self.tokenizer,
                                            self.max_length) for c in codes])
        arrays = {
            "input_ids": enc["input_ids"],
            "attention_mask": enc["attention_mask"],
            "ast_input_ids": ast_enc["input_ids"],
            "ast_attention_mask": ast_enc["attention_mask"],
            "token_to_line": ttl,
        }
        return {k: torch.from_numpy(np.asarray(v, np.int64)).to(self.device)
                for k, v in arrays.items()}

    @torch.inference_mode()
    def _detect(self, batch: Dict[str, torch.Tensor]):
        """Contract and line probabilities, on the device.

        The JAX analyzer calls the full model forward (with ``target_ids``),
        but under ``jax.jit`` XLA drops the teacher-forced decoder, the
        vocab-wide LM head and the discriminator as dead code, since only the
        two sigmoid heads are returned. Eager PyTorch has no such pass, so
        the port runs exactly what the compiled program runs: encode →
        contract head → line head."""
        memory = self.model.encode(batch["input_ids"],
                                   batch["attention_mask"],
                                   batch["ast_input_ids"],
                                   batch["ast_attention_mask"])
        contract_logits, _ = self.model.contract_head(memory)
        line_logits = self.model.line_head(memory, batch["token_to_line"])
        return torch.sigmoid(contract_logits), torch.sigmoid(line_logits)

    # -- detection API -------------------------------------------------------
    def detect_vulnerabilities(self, contract_code: str,
                               threshold: float = 0.5) -> Dict[str, Any]:
        """Contract and line vulnerability flags plus raw probabilities."""
        cp, lp = self._detect(self._prepare_inputs([contract_code]))
        cp, lp = cp.cpu().numpy(), lp.cpu().numpy()
        return self._format_result(contract_code, cp[0], lp[0], threshold,
                                   line_probs_full=lp)

    def _format_result(self, contract_code: str, contract_probs: np.ndarray,
                       line_probs: np.ndarray, threshold: float,
                       line_probs_full: Optional[np.ndarray] = None
                       ) -> Dict[str, Any]:
        lines = contract_code.split("\n")
        num_lines = len(lines)
        if self.line_fusion and line_probs.shape[0]:
            valid = line_probs[:min(line_probs.shape[0], num_lines)]
            # slots the model zeroed (padding / empty lines) sit at exactly
            # sigmoid(0) = 0.5; they are excluded from the max
            informative = np.where(valid != 0.5, valid, 0.0)
            if informative.size:
                contract_probs = np.maximum(contract_probs,
                                            informative.max(axis=0))
        line_preds = line_probs > threshold
        if line_preds.shape[0] > num_lines:
            line_preds = line_preds[:num_lines]
        elif line_preds.shape[0] < num_lines:
            pad = np.zeros((num_lines - line_preds.shape[0],
                            line_preds.shape[1]), dtype=bool)
            line_preds = np.concatenate([line_preds, pad], axis=0)
        line_vulnerabilities = {
            i: {vt: bool(line_preds[i, j])
                for j, vt in enumerate(self.vulnerability_types)}
            for i in range(num_lines)
        }
        contract_preds = contract_probs > threshold
        return {
            "contract_vulnerabilities": {
                vt: bool(contract_preds[j])
                for j, vt in enumerate(self.vulnerability_types)},
            "line_vulnerabilities": line_vulnerabilities,
            "contract_probabilities": [contract_probs.tolist()],
            "line_probabilities": (line_probs_full.tolist()
                                   if line_probs_full is not None
                                   else [line_probs.tolist()]),
        }

    def analyze_multiple_contracts(self, contract_codes: List[str],
                                   threshold: float = 0.5
                                   ) -> List[Dict[str, Any]]:
        """Detection in batches of ``batch_size`` (the last one padded by
        repeating its final contract). One batch deep of pipelining: the
        next batch's host preparation overlaps this batch's device work."""
        results: List[Dict[str, Any]] = []
        bs = self.batch_size

        def dispatch(chunk):
            padded = chunk + [chunk[-1]] * (bs - len(chunk))
            return self._detect(self._prepare_inputs(padded))

        def collect(start, chunk, handles):
            cp, lp = (h.cpu().numpy() for h in handles)
            for i, code in enumerate(chunk):
                res = self._format_result(code, cp[i], lp[i], threshold)
                res["contract_index"] = start + i
                res["contract_code"] = code
                results.append(res)

        pending = None
        for start in range(0, len(contract_codes), bs):
            chunk = contract_codes[start:start + bs]
            handles = dispatch(chunk)
            if pending is not None:
                collect(*pending)
            if start and start % (bs * 8) == 0:
                self._log(f"analyzed {start}/{len(contract_codes)} contracts")
            pending = (start, chunk, handles)
        if pending is not None:
            collect(*pending)
        return results

    def get_vulnerability_summary(self, results: List[Dict[str, Any]]
                                  ) -> Dict[str, Any]:
        """Summary statistics across analyzed contracts."""
        summary = {
            "total_contracts": len(results),
            "vulnerable_contracts": 0,
            "vulnerability_counts": {vt: 0 for vt in self.vulnerability_types},
            "most_common_vulnerabilities": [],
            "contracts_by_vulnerability": {vt: [] for vt
                                           in self.vulnerability_types},
        }
        for result in results:
            contract_vulns = result["contract_vulnerabilities"]
            if any(contract_vulns.values()):
                summary["vulnerable_contracts"] += 1
            for vt, flag in contract_vulns.items():
                if flag:
                    summary["vulnerability_counts"][vt] += 1
                    summary["contracts_by_vulnerability"][vt].append(
                        result["contract_index"])
        summary["most_common_vulnerabilities"] = sorted(
            summary["vulnerability_counts"].items(), key=lambda x: x[1],
            reverse=True)
        return summary

    # -- generation API ------------------------------------------------------
    def generate_synthetic_contract(self, contract_template: str,
                                    num_contracts: int = 1,
                                    temperature: float = 0.8,
                                    max_length: int = 1024,
                                    use_beam_search: bool = False,
                                    beam_size: int = 3) -> List[str]:
        """Sample ``num_contracts`` contracts conditioned on a template, all
        decoded as one batch. ``max_length`` and ``beam_size`` are accepted
        for API parity: as in the JAX analyzer, sampling runs to the model's
        ``max_length``."""
        if use_beam_search:
            raise NotImplementedError("beam search is not ported yet")
        batch = self._prepare_inputs([contract_template])
        tile = {k: v.expand(num_contracts, -1) for k, v in batch.items()}
        with torch.inference_mode():
            memory = self.model.encode(tile["input_ids"],
                                       tile["attention_mask"],
                                       tile["ast_input_ids"],
                                       tile["ast_attention_mask"])
        tokens, self.last_decode_steps = self._generate_fn(
            memory, tile["attention_mask"].bool(), self._generator,
            temperature)
        generated: List[str] = []
        for seq in tokens.cpu().numpy():
            code = self.tokenizer.decode(seq, skip_special_tokens=True).strip()
            if len(code) > 10 and not code.isspace():
                generated.append(code)
            else:   # empty decode: the template transform stands in
                generated.append(
                    self.generate_template_based_contract(contract_template))
        return generated

    def generate_template_based_contract(self, contract_template: str) -> str:
        """Regex-transform generation (the fallback for empty decodes)."""
        modified = contract_template
        transformations = [
            lambda c: re.sub(r"\bvalue\b",
                             random.choice(["data", "state", "storage",
                                            "value"]), c),
            lambda c: re.sub(r"\b_value\b",
                             random.choice(["_data", "_state", "_storage",
                                            "_value"]), c),
            lambda c: re.sub(r"\bsetValue\b",
                             random.choice(["setData", "setState",
                                            "setStorage", "setValue"]), c),
            lambda c: re.sub(r"\bgetValue\b",
                             random.choice(["getData", "getState",
                                            "getStorage", "getValue"]), c),
            lambda c: re.sub(r"\bpublic\b",
                             random.choice(["public", "external"]), c),
            lambda c: re.sub(r"\bprivate\b",
                             random.choice(["private", "internal"]), c),
            lambda c: c.replace("function", "// Modified function"),
            lambda c: re.sub(
                r"pragma solidity \^?0\.\d+\.\d+",
                f"pragma solidity ^{random.randint(4, 8)}."
                f"{random.randint(0, 20)}.{random.randint(0, 20)}", c),
        ]
        n = random.randint(2, 3)
        for transform in random.sample(transformations, n):
            modified = transform(modified)
        header = (f"// Generated contract based on template\n"
                  f"// Applied {n} transformations\n")
        return header + modified
