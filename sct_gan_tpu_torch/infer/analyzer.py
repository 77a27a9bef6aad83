"""SmartContractAnalyzer — the serving engine of the port.

Counterpart of ``sct_gan_tpu/infer/analyzer.py``: loading a checkpoint
written by the port's trainer (``model_path``), ``detect_vulnerabilities``
with its fallback tiers (``detect_vulnerabilities_with_fallback``,
``detect_vulnerabilities_safe``), batched ``analyze_multiple_contracts``,
``get_vulnerability_summary``, ``generate_synthetic_contract`` (sampling or
beam search), ``generate_template_based_contract``,
``generate_simple_contract`` and the diagnostics
(``test_model_functionality``, ``diagnose_generation_model``,
``debug_forward``, ``test_generation_simple``).

With a ``mesh`` (``parallel.make_mesh``, one process per rank) the
parameters are replicated and ``analyze_multiple_contracts`` carries
``batch_size × dp`` contracts per dispatch: each rank forwards its rows (the
line head's batch-wide statistics reduced over dp, as GSPMD reduces them
over the dispatch), and the results are gathered, so every rank returns the
list one card returns at ``batch_size × dp``. Every other entry point runs
whole on each rank.

Errors propagate. A fallback tier catches only the ``ValueError`` the port
raises for input it cannot take; an error from a kernel, its build or CUDA
(``RuntimeError``, ``torch.OutOfMemoryError``) is never caught. Generation
keeps the JAX analyzer's empty-decode fallback (a sequence that decodes to
almost nothing is replaced by the template transform), not its catch-all.
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
from ..data import ast_parser
from ..data.dataset import build_token_to_line
from ..data.tokenizer import get_tokenizer
from ..models.sct_transformer import SmartContractTransformer
from ..parallel.collectives import SINGLE, all_gather
from ..parallel.mesh import local_slice
from ..train.checkpoint import adapt_vocab_params, load_checkpoint
from ..utils import resolve_device
from .generate import (BOS_ID, make_beam_search_fn, make_generate_fn,
                       syntax_boost_ids)


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
    kernels, the CPU their plain versions. ``mesh``: see the module's
    docstring; its device is the rank's, and ``device`` is not read.
    """

    def __init__(self, model_path: Optional[str] = None,
                 tokenizer_name: str = "microsoft/codebert-base",
                 device: Union[str, torch.device] = "cuda",
                 use_gan: bool = True,
                 model_config: Optional[ModelConfig] = None,
                 params: Optional[Union[str, Mapping[str, Any]]] = None,
                 tokenizer=None, batch_size: int = 8, verbose: bool = True,
                 line_fusion: bool = True, seed: int = 0, mesh=None):
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
        self.mesh = mesh
        self._dp = SINGLE if mesh is None else mesh.axis("dp")
        self.device = resolve_device(device) if mesh is None else mesh.device

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
        self._beam_fns: Dict[int, Any] = {}   # one beam search per beam size
        self.last_decode_steps = 0   # decode steps of the last generation

    # -- AST helpers -----------------------------------------------------------
    def parse_solidity_to_ast(self, code: str):
        return ast_parser.parse_solidity_to_ast(code)

    def prepare_code2vec_input(self, ast):
        return ast_parser.prepare_code2vec_input(ast)

    # -- input preparation ---------------------------------------------------
    def _prepare_inputs(self, codes: List[str]) -> Dict[str, torch.Tensor]:
        asts = [self.parse_solidity_to_ast(c) for c in codes]
        path_texts = [" ".join(self.prepare_code2vec_input(a)) if a else ""
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

    @torch.inference_mode()
    def _detect_contract(self, batch: Dict[str, torch.Tensor]):
        """Contract probabilities alone: encode → contract head."""
        memory = self.model.encode(batch["input_ids"],
                                   batch["attention_mask"],
                                   batch["ast_input_ids"],
                                   batch["ast_attention_mask"])
        return torch.sigmoid(self.model.contract_head(memory)[0])

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

    def detect_vulnerabilities_with_fallback(self, contract_code: str,
                                             threshold: float = 0.5
                                             ) -> Dict[str, Any]:
        """Detection with the JAX analyzer's fallback chain: the full
        forward, else contract-only with zero line probabilities. The JAX
        chain's middle tier (the forward again without ``target_ids``,
        decoder skipped, both heads kept) is the computation the port's
        full tier already runs (``_detect``), so it is that tier here. A
        tier falls through only on the port's ``ValueError``s."""
        try:
            return self.detect_vulnerabilities(contract_code, threshold)
        except ValueError as e:
            self._log(f"Full forward failed ({e}); using the contract-only "
                      f"fallback pass")
        return self._fallback_forward_pass(contract_code, threshold)

    def _fallback_forward_pass(self, contract_code: str,
                               threshold: float = 0.5) -> Dict[str, Any]:
        """Contract-level detection with zero line probabilities."""
        cp = self._detect_contract(self._prepare_inputs([contract_code]))
        zeros = np.zeros((self.max_length, len(self.vulnerability_types)),
                         np.float32)
        return self._format_result(contract_code, cp.cpu().numpy()[0], zeros,
                                   threshold)

    def detect_vulnerabilities_safe(self, contract_code: str,
                                    threshold: float = 0.5) -> Dict[str, Any]:
        """Contract-only analysis, the line head skipped."""
        return self._fallback_forward_pass(contract_code, threshold)

    def analyze_multiple_contracts(self, contract_codes: List[str],
                                   threshold: float = 0.5
                                   ) -> List[Dict[str, Any]]:
        """Detection in batches of ``batch_size`` (the last one padded by
        repeating its final contract). One batch deep of pipelining: the
        next batch's host preparation overlaps this batch's device work."""
        results: List[Dict[str, Any]] = []
        dp = self._dp
        bs = self.batch_size * dp.size

        def dispatch(chunk):
            padded = chunk + [chunk[-1]] * (bs - len(chunk))
            batch = self._prepare_inputs(padded)
            rows = local_slice(bs, dp, "batch")     # all of them on one rank
            self.model.shards.dp = dp
            try:
                probs = self._detect({k: v[rows] for k, v in batch.items()})
            finally:
                self.model.shards.dp = SINGLE
            return tuple(all_gather(p, dp) for p in probs)

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
        """Generate ``num_contracts`` contracts conditioned on a template.
        Sampling decodes them all as one batch; beam search (one
        ``make_beam_search_fn`` per ``beam_size``, kept) decodes the
        template once, since its rows would be identical, and repeats the
        sequence. ``max_length`` is accepted for API parity: as in the JAX
        analyzer, both run to the model's ``max_length``."""
        batch = self._prepare_inputs([contract_template])
        if use_beam_search:
            if beam_size not in self._beam_fns:
                self._beam_fns[beam_size] = make_beam_search_fn(
                    self.model, beam_size=beam_size)
            beam = self._beam_fns[beam_size]
            out = beam(batch["input_ids"], batch["attention_mask"],
                       batch["ast_input_ids"], batch["ast_attention_mask"],
                       temperature)
            tokens = out["generated_sequence"][:1].expand(num_contracts, -1)
            self.last_decode_steps = beam.last_steps
        else:
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

    # -- diagnostics -----------------------------------------------------------
    def test_model_functionality(self) -> Dict[str, Any]:
        """A detection forward on a random batch of one: its output shapes,
        or the port's refusal of the input."""
        rng = np.random.default_rng(0)
        vocab = min(1000, self.config.vocab_size)
        ones = np.ones((1, self.max_length), np.int64)
        arrays = {
            "input_ids": rng.integers(0, vocab, (1, self.max_length)),
            "attention_mask": ones,
            "ast_input_ids": rng.integers(0, vocab, (1, self.max_length)),
            "ast_attention_mask": ones,
            "token_to_line": np.zeros((1, self.max_length), np.int64),
        }
        batch = {k: torch.from_numpy(v).to(self.device)
                 for k, v in arrays.items()}
        try:
            cp, lp = self._detect(batch)
        except ValueError as e:
            return {"success": False, "error": str(e)}
        return {"success": True,
                "contract_logits_shape": tuple(cp.shape),
                "line_logits_shape": tuple(lp.shape)}

    @torch.inference_mode()
    def diagnose_generation_model(self) -> Dict[str, Any]:
        """The output layer's weight spread and the first decode step's top
        tokens on a tiny contract ("token-1 collapse": BOS predicted)."""
        out = self.model.output_layer
        weight, bias = out.weight.float(), out.bias.float()
        report = {
            "output_weight_std": float(weight.std(correction=0)),
            "output_bias_std": float(bias.std(correction=0)),
            "healthy_weights": bool(weight.std(correction=0) > 1e-4),
        }
        batch = self._prepare_inputs(
            ["pragma solidity ^0.8.0;\ncontract T { uint x; }"])
        memory = self.model.encode(batch["input_ids"],
                                   batch["attention_mask"],
                                   batch["ast_input_ids"],
                                   batch["ast_attention_mask"])
        logits = self.model.decode_step(
            torch.full((1, 1), BOS_ID, dtype=torch.long, device=self.device),
            0, self.model.init_decode_cache(1, self.device),
            self.model.precompute_cross_kv(memory),
            batch["attention_mask"].bool())
        top = np.argsort(-logits[0].cpu().numpy())[:5]
        report["first_step_top_tokens"] = top.tolist()
        report["token_1_collapse"] = bool(top[0] == 1)
        return report

    @torch.inference_mode()
    def debug_forward(self, contract_code: str) -> Dict[str, Any]:
        """Mean, std, min and max of the line head's three stages
        (``line_means``, ``line_extracted``, ``line_logits``) on one
        contract, each flagged ``collapsed`` when its std is under 1e-6.
        The statistics are recorded only when a dict is handed to
        ``line_head``, which detection never does."""
        batch = self._prepare_inputs([contract_code])
        memory = self.model.encode(batch["input_ids"],
                                   batch["attention_mask"],
                                   batch["ast_input_ids"],
                                   batch["ast_attention_mask"])
        recorded: Dict[str, Dict[str, torch.Tensor]] = {}
        self.model.line_head(memory, batch["token_to_line"], stats=recorded)
        stats = {name: {k: float(v) for k, v in s.items()}
                 for name, s in recorded.items()}
        for s in stats.values():
            s["collapsed"] = bool(s["std"] < 1e-6)
        return stats

    def test_generation_simple(self, max_tokens: int = 64) -> Dict[str, Any]:
        """One sampled contract from a tiny template: its length and a
        preview, or the port's refusal of the input."""
        code = "pragma solidity ^0.8.0;\ncontract T { uint x; }"
        try:
            outs = self.generate_synthetic_contract(code, num_contracts=1,
                                                    temperature=0.8)
        except ValueError as e:
            return {"success": False, "error": str(e)}
        return {"success": True, "generated_length": len(outs[0]),
                "preview": outs[0][:200]}

    def generate_simple_contract(self, prompt: str = "",
                                 max_length: int = 256,
                                 temperature: float = 0.8,
                                 repetition_penalty: float = 1.0) -> str:
        """The reference's diagnostic sampler: top-k 50, top-p 1.0, EOS/PAD
        stop after 20 tokens, repetition tracking (noise after 3 repeats of
        a token, a stop after 8); ``repetition_penalty`` != 1 also
        penalises the previous token's logit (off by default, as in the
        JAX analyzer)."""
        batch = self._prepare_inputs([prompt or "pragma solidity ^0.8.0;"])
        with torch.inference_mode():
            memory = self.model.encode(batch["input_ids"],
                                       batch["attention_mask"],
                                       batch["ast_input_ids"],
                                       batch["ast_attention_mask"])
        gen = make_generate_fn(self.model, self.syntax_ids, top_k=50,
                               top_p=1.0, min_length=20,
                               max_length=min(max_length, self.max_length),
                               repetition_penalty=repetition_penalty,
                               track_repetition=True)
        tokens, self.last_decode_steps = gen(
            memory, batch["attention_mask"].bool(), self._generator,
            temperature)
        return self.tokenizer.decode(tokens[0].cpu().numpy(),
                                     skip_special_tokens=True)
