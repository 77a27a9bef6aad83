"""TASC GAN trainers (binary and multiclass) of the port.

Counterpart of ``sct_gan_tpu/variants/tasc_trainer.py`` (parity with
``Binary-TASC-model/train.py:156-418`` and
``MultiClass-TASC-model/train_code_loc.py:160-591``):

  * ``SolidityCodeLoss``: CE (ignore_index=0) + the weighted keyword
    probability syntax loss, keeping the reference's quirk of reading every
    rule's probability at the first flattened target token;
    ``check_solidity_syntax`` and the token-set Jaccard
    ``compute_semantic_similarity``;
  * ``VulnerabilityDetectionTrainer``: the 3/4-optimizer GAN step, the
    PatternMatcher weak labels, ``train_epoch``, ``validate``, ``save`` /
    ``restore`` (``train/checkpoint.py``: ``state.npz`` in flax naming and
    the JAX sidecar) and ``train``.

One step, as the JAX step: the frozen CodeBERT embeddings go through the
encoder in training mode without gradients (dropout on: K1 with its
dropout and K6 on the card), then four sequential updates, each loss
computed with its submodules in eval mode (the JAX losses run
deterministic):

  1. G: BCE(D(G(mean)), 1), stepping the generator;
  2. D: real = the malicious flags, fake = the pre-update generator's
     output (the one G's loss saw);
  3. decoder: teacher-forced from the pragma-solidity seed against the
     input ids (decoder vocab clipped). The decoder ignores its synthetic
     input, so the post-update generator's output is not formed;
  4. multiclass: the classifier against the type labels and the weak
     pattern labels.

Each step differentiates its loss with respect to its own submodule's
parameters only and steps a ``torch.optim.Adam(lr, betas=(b1, 0.999),
eps=1e-8)`` over them: optax's ``adam`` over that submodule, as the
reference steps each Adam over its submodule (train.py:168-183). The JAX
trainer differs here: its ``optax.masked`` optimizers pass the other
subtrees' updates through unchanged, so its G step adds the raw
``∂g_loss/∂D`` to the discriminator. The port does not copy that.
"""
from __future__ import annotations

import re
import time
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ..config import CodeBERTConfig, TASCConfig
from ..convert import (convert_flax_params, convert_tasc_opt_states,
                       flax_params_from_torch, tasc_opt_states_from_torch)
from ..data.pattern_matcher import PatternMatcher
from ..utils import resolve_device
from .codebert import FlaxCodeBERT, load_codebert_params
from .tasc import PATTERN_HEADS, SPECIAL_TOKENS, SmartContractVulnerabilityGAN

_SYNTAX_RULES = {"pragma": 0.2, "contract": 0.15, "function": 0.15,
                 "returns": 0.1, "public": 0.1, "private": 0.1,
                 "view": 0.1, "pure": 0.1}
_TOKEN_MAPPINGS = {"pragma": ["pragma", "solidity"], "contract": ["contract"],
                   "function": ["function"], "returns": ["returns"],
                   "public": ["public"], "private": ["private"],
                   "view": ["view"], "pure": ["pure"]}


class SolidityCodeLoss:
    """CE + keyword-probability syntax loss (train.py:15-141)."""

    def __init__(self, vocab_size: int = 50000):
        self.vocab_size = vocab_size

    def __call__(self, decoded_code: torch.Tensor,
                 target_ids: torch.Tensor) -> torch.Tensor:
        v = decoded_code.shape[-1]
        logp = F.log_softmax(decoded_code.reshape(-1, v).float(), dim=-1)
        targets = target_ids.reshape(-1).long().clamp(0, self.vocab_size - 1)
        nll = -logp.gather(1, targets[:, None])[:, 0]
        mask = (targets != 0).float()                # ignore_index=0
        ce = (nll * mask).sum() / mask.sum().clamp(min=1.0)
        return ce + self._syntax_loss(logp, targets)

    def _syntax_loss(self, logp, targets):
        """Reference quirk kept (train.py:119-141): every rule's token
        probability is read at index ``targets[0]``. Only that column of
        the softmax is formed."""
        token_prob = logp[:, targets[0]].exp().mean()
        loss = torch.zeros((), device=logp.device)
        for rule, weight in _SYNTAX_RULES.items():
            for _ in _TOKEN_MAPPINGS[rule]:
                loss = loss + weight * (1.0 - token_prob)
        return loss

    @staticmethod
    def check_solidity_syntax(code: str) -> bool:
        """pragma + contract + balanced braces/parens (train.py:45-88)."""
        if not re.search(r"pragma\s+solidity\s+[\^]?[0-9]+\.[0-9]+(\.[0-9]+)?",
                         code):
            return False
        if not re.search(r"contract\s+\w+", code):
            return False
        for open_c, close_c in (("{", "}"), ("(", ")")):
            count = 0
            for ch in code:
                if ch == open_c:
                    count += 1
                elif ch == close_c:
                    count -= 1
                if count < 0:
                    return False
            if count != 0:
                return False
        return True

    @staticmethod
    def compute_semantic_similarity(generated_code: str,
                                    original_code: str) -> float:
        """Token-set Jaccard (train.py:143-154)."""
        gen = set(re.findall(r"\w+", generated_code))
        orig = set(re.findall(r"\w+", original_code))
        if not gen or not orig:
            return 0.0
        union = len(gen | orig)
        return len(gen & orig) / union if union else 0.0


def _bce(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    p = p.clamp(1e-7, 1 - 1e-7)
    return -(t * torch.log(p) + (1 - t) * torch.log(1 - p)).mean()


class VulnerabilityDetectionTrainer:
    """3/4-optimizer TASC GAN trainer.

    Takes the JAX trainer's arguments plus ``device``: the card
    (``"cuda"``) by default; without one it raises unless ``device="cpu"``
    is passed. ``codebert_params`` is a state dict of ``FlaxCodeBERT``
    (default: ``load_codebert_params``). The model's f32 parameters move
    to the device and are trained in place; the dropout seeds come from a
    ``torch.Generator`` seeded with ``seed``."""

    def __init__(self, model: SmartContractVulnerabilityGAN,
                 train_dataloader, val_dataloader,
                 learning_rate: float = 2e-4, beta1: float = 0.5,
                 tokenizer=None, codebert_params=None, seed: int = 0,
                 verbose: bool = True,
                 device: Union[str, torch.device] = "cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg: TASCConfig = model.config
        self.train_dataloader = train_dataloader
        self.val_dataloader = val_dataloader
        self.tokenizer = tokenizer
        self._log = print if verbose else (lambda *a, **k: None)
        self.decoder_loss = SolidityCodeLoss(self.cfg.decoder_vocab_size)
        self.pattern_matcher = (PatternMatcher() if self.cfg.multiclass
                                else None)
        self.generator = torch.Generator().manual_seed(seed)

        # frozen CodeBERT embedder, in the config's compute dtype
        self.codebert = FlaxCodeBERT.from_config(
            CodeBERTConfig.from_tasc(self.cfg), seed=None)
        self.codebert.load_state_dict(
            codebert_params if codebert_params is not None
            else load_codebert_params(self.codebert))
        self.codebert.to(self.device).eval().requires_grad_(False)

        # per-submodule Adam optimizers (train.py:168-183)
        self.opt_keys = ["generator", "discriminator", "decoder"]
        if self.cfg.multiclass:
            self.opt_keys.append("vulnerability_classifier")
        self._named = {k: list(getattr(model, k).named_parameters(prefix=k))
                       for k in self.opt_keys}
        self.optimizers = {
            k: torch.optim.Adam([p for _, p in self._named[k]],
                                lr=learning_rate, betas=(beta1, 0.999),
                                eps=1e-8)
            for k in self.opt_keys}

        self.best_val_loss = float("inf")
        self.training_history: Dict[str, List[float]] = {
            "g_loss": [], "d_loss": [], "decoder_loss": [], "val_loss": [],
            "classifier_loss": [], "epoch_times": []}

    # -- host to device ----------------------------------------------------
    def _t(self, x, dtype=torch.long) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x)).to(self.device, dtype)

    def _embed(self, ids, mask) -> torch.Tensor:
        """Frozen CodeBERT embeddings (B, S, d) f32, without gradients."""
        with torch.no_grad():
            return self.codebert(self._t(ids), self._t(mask))

    # -- the step ------------------------------------------------------------
    def _apply(self, key: str, loss: torch.Tensor) -> None:
        """Step submodule ``key``'s Adam with ∂loss/∂(its parameters) only:
        no other parameter receives a gradient. A parameter the loss does
        not reach gets a zero gradient (optax's masked Adam still decays
        its moments)."""
        params = [p for _, p in self._named[key]]
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        for p, g in zip(params, grads):
            p.grad = torch.zeros_like(p) if g is None else g
        self.optimizers[key].step()
        for p in params:
            p.grad = None

    def _g_step(self, mean_emb: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """G step with the current D; returns (g_loss, the pre-update
        generator's output, detached)."""
        m = self.model
        synthetic = m.generator(mean_emb)
        fake = m.discriminator(synthetic)
        g_loss = _bce(fake, torch.ones_like(fake))
        self._apply("generator", g_loss)
        return g_loss.detach(), synthetic.detach()

    def _d_step(self, mean_emb, synthetic_old, labels) -> torch.Tensor:
        """D step: the "real" labels are the malicious flags
        (train.py:270)."""
        m = self.model
        real = m.discriminator(mean_emb)
        fake = m.discriminator(synthetic_old)
        d_loss = (_bce(real, labels.view(-1, 1))
                  + _bce(fake, torch.zeros_like(fake))) / 2.0
        self._apply("discriminator", d_loss)
        return d_loss.detach()

    def _decoder_step(self, transformed, contract_ids) -> torch.Tensor:
        """Decoder step from the pragma-solidity seed prefixing the clipped
        contract ids (the JAX package's deviation from the reference's
        2-token decode, train.py:283-321)."""
        b = contract_ids.shape[0]
        vmax = self.decoder_loss.vocab_size - 1
        seed = torch.cat([
            torch.full((b, 1), SPECIAL_TOKENS["pragma"], dtype=torch.long,
                       device=self.device),
            torch.full((b, 1), SPECIAL_TOKENS["solidity"], dtype=torch.long,
                       device=self.device),
            contract_ids[:, 2:].clamp(0, vmax)], dim=1)
        decoded = self.model.decoder(None, transformed, seed)
        dec_loss = self.decoder_loss(decoded, contract_ids)
        self._apply("decoder", dec_loss)
        return dec_loss.detach()

    def _classifier_step(self, mean_emb, vuln_labels,
                         pattern_labels) -> torch.Tensor:
        vout = self.model.vulnerability_classifier(mean_emb)
        loss = _bce(vout["vulnerability_scores"], vuln_labels)
        for k in PATTERN_HEADS:
            loss = loss + _bce(vout["pattern_scores"][k], pattern_labels[k])
        self._apply("vulnerability_classifier", loss)
        return loss.detach()

    def _train_step(self, contract_emb, path_emb, contract_ids, labels,
                    vuln_labels, pattern_labels) -> Dict[str, torch.Tensor]:
        """One GAN step on device tensors; the metrics stay on the
        device."""
        combined = contract_emb + path_emb
        transformer = self.model.transformer
        with torch.no_grad():
            transformer.train()
            try:
                transformed, mean_emb = self.model.encode(combined,
                                                          self.generator)
            finally:
                transformer.eval()
        g_loss, synthetic_old = self._g_step(mean_emb)
        d_loss = self._d_step(mean_emb, synthetic_old, labels)
        dec_loss = self._decoder_step(transformed, contract_ids)
        cls_loss = (self._classifier_step(mean_emb, vuln_labels,
                                          pattern_labels)
                    if self.cfg.multiclass
                    else torch.zeros((), device=self.device))
        return {"g_loss": g_loss, "d_loss": d_loss,
                "decoder_loss": dec_loss, "classifier_loss": cls_loss}

    # ------------------------------------------------------------------
    def _pattern_labels(self, contract_ids: np.ndarray
                        ) -> Dict[str, np.ndarray]:
        """PatternMatcher weak labels from decoded batch ids
        (train_code_loc.py:269-283)."""
        out = {k: [] for k in PATTERN_HEADS}
        for row in np.asarray(contract_ids):
            code = (self.tokenizer.decode(row) if self.tokenizer is not None
                    else "")
            tensors = self.pattern_matcher.get_pattern_tensor(code)
            for k in PATTERN_HEADS:
                out[k].append(tensors[k])
        return {k: np.stack(v).astype(np.float32) for k, v in out.items()}

    def _batch_labels(self, batch: Dict, contract_ids: np.ndarray):
        """(labels, vulnerability labels, pattern labels) on the device."""
        b = contract_ids.shape[0]
        labels = self._t(batch["label"], torch.float32)
        if self.cfg.multiclass:
            vuln = batch.get("vulnerability_labels",
                             np.zeros((b, self.cfg.num_vulnerability_types)))
            pattern = self._pattern_labels(contract_ids)
        else:
            vuln = np.zeros((b, self.cfg.num_vulnerability_types))
            pattern = {k: np.zeros((b, n)) for k, n in PATTERN_HEADS.items()}
        return (labels, self._t(vuln, torch.float32),
                {k: self._t(v, torch.float32) for k, v in pattern.items()})

    def train_epoch(self) -> Tuple[float, float, float]:
        keys = ("g_loss", "d_loss", "decoder_loss", "classifier_loss")
        sums = dict.fromkeys(keys, 0.0)
        count = 0
        for batch in self.train_dataloader:
            contract_ids = np.asarray(batch["input_ids"])
            ce = self._embed(batch["input_ids"], batch["attention_mask"])
            pe = self._embed(batch["path_input_ids"],
                             batch["path_attention_mask"])
            labels, vuln, pattern = self._batch_labels(batch, contract_ids)
            metrics = self._train_step(ce, pe, self._t(contract_ids), labels,
                                       vuln, pattern)
            vec = torch.stack([metrics[k].float() for k in keys]).cpu()
            for k, v in zip(keys, vec.tolist()):
                sums[k] += v
            count += 1
        avg = {k: v / max(count, 1) for k, v in sums.items()}
        for k in keys:
            self.training_history[k].append(avg[k])
        return avg["g_loss"], avg["d_loss"], avg["decoder_loss"]

    @torch.no_grad()
    def validate(self) -> float:
        """Val loss + code-quality metrics (train.py:357-418). The decoder
        reads the input ids clipped to its vocab (the JAX package feeds
        them unclipped, and its embedding gives NaN rows past the vocab);
        the loss, from the discriminator's real scores, does not see
        them."""
        val_loss = 0.0
        quality = {"syntax_correct": 0, "compilable": 0,
                   "semantic_similarity": 0.0}
        pattern_correct = {k: 0 for k in PATTERN_HEADS}
        pattern_total = 0
        batches = 0
        vmax = self.cfg.decoder_vocab_size - 1
        for batch in self.val_dataloader:
            ce = self._embed(batch["input_ids"], batch["attention_mask"])
            pe = self._embed(batch["path_input_ids"],
                             batch["path_attention_mask"])
            labels = np.asarray(batch["label"], np.float32).reshape(-1, 1)
            tgt = np.asarray(batch["input_ids"], np.int64)
            out = self.model(ce, pe,
                             target_sequence=self._t(np.clip(tgt, 0, vmax)))
            p = np.clip(out["real_scores"].cpu().numpy(), 1e-7, 1 - 1e-7)
            val_loss += float(-(labels * np.log(p)
                                + (1 - labels) * np.log(1 - p)).mean())
            if self.tokenizer is not None:
                ids = out["decoded_code"][0].argmax(-1).cpu().numpy()
                generated = self.tokenizer.decode(ids)
                if SolidityCodeLoss.check_solidity_syntax(generated):
                    quality["syntax_correct"] += 1
                    quality["compilable"] += 1
                quality["semantic_similarity"] += (
                    SolidityCodeLoss.compute_semantic_similarity(
                        generated, self.tokenizer.decode(tgt[0])))
            if self.cfg.multiclass and self.tokenizer is not None:
                # per-pattern accuracy vs weak labels (train_code_loc:472-591)
                weak = self._pattern_labels(tgt)
                for k in PATTERN_HEADS:
                    pred = out["pattern_scores"][k].cpu().numpy() > 0.5
                    true = weak[k] > 0.5
                    pattern_correct[k] += int((pred == true).sum())
                pattern_total += tgt.shape[0]
            batches += 1
        avg = val_loss / max(batches, 1)
        self.training_history["val_loss"].append(avg)
        if batches:
            self._log(f"Validation Loss: {avg:.4f}")
            self._log("Syntax Correct: "
                      f"{quality['syntax_correct'] / batches:.2%}")
            self._log(f"Compilable: {quality['compilable'] / batches:.2%}")
            self._log("Semantic Similarity: "
                      f"{quality['semantic_similarity'] / batches:.4f}")
            if self.cfg.multiclass and pattern_total:
                for k, n in PATTERN_HEADS.items():
                    acc = pattern_correct[k] / (pattern_total * n)
                    self._log(f"Pattern accuracy [{k}]: {acc:.2%}")
        return avg

    # -- state -------------------------------------------------------------
    def adam_states(self) -> Dict[str, Dict[str, Any]]:
        """Each optimizer's state as ``{"count", "mu", "nu"}`` by port
        parameter name: views of the live moments (zeros, count 0, before
        the first step, as optax's initial state)."""
        out = {}
        for k in self.opt_keys:
            opt = self.optimizers[k]
            st = {"count": 0, "mu": {}, "nu": {}}
            for name, p in self._named[k]:
                s = opt.state.get(p, {})
                if s:
                    st["count"] = int(s["step"])
                st["mu"][name] = s.get("exp_avg", torch.zeros_like(p))
                st["nu"][name] = s.get("exp_avg_sq", torch.zeros_like(p))
            st["count"] = np.asarray(st["count"], np.int32)
            out[k] = st
        return out

    def state_tree(self) -> Dict[str, Any]:
        """Params and the 3/4 Adam states in flax naming, as a checkpoint
        holds them (views of the live tensors)."""
        return {"params": flax_params_from_torch(
                    dict(self.model.named_parameters()), self.cfg),
                "opt_states": tasc_opt_states_from_torch(self.adam_states(),
                                                         self.cfg)}

    def _load_state(self, tree: Dict[str, Any]) -> None:
        """Copy a flax-named state tree into the live parameters and the
        Adam states (in place: the optimizers hold the parameters)."""
        sd = convert_flax_params(tree["params"], self.cfg)
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                p.copy_(sd[name])
        for k, st in convert_tasc_opt_states(tree["opt_states"],
                                             self.cfg).items():
            opt = self.optimizers[k]
            for name, p in self._named[k]:
                opt.state[p] = {
                    "step": torch.tensor(float(st["count"]),
                                         dtype=torch.float32),
                    "exp_avg": st["mu"][name].to(p.device).clone(),
                    "exp_avg_sq": st["nu"][name].to(p.device).clone()}

    def save(self, checkpoint_dir: str, name: str = "tasc_best") -> str:
        """Persist the full TASC training state: params, all per-submodule
        Adam states, best val loss and history (Binary-TASC-model/
        main.ipynb cell 21), as ``<dir>/<name>/state.npz`` plus the JSON
        sidecar (``train/checkpoint.py``)."""
        from ..train.checkpoint import save_checkpoint
        meta = {
            "best_val_loss": self.best_val_loss,
            "training_history": self.training_history,
            "multiclass": self.cfg.multiclass,
            "epochs_run": len(self.training_history["g_loss"]),
        }
        return save_checkpoint(checkpoint_dir, name, self.state_tree(), meta)

    def restore(self, checkpoint_path: str) -> int:
        """Restore params + the 3/4 Adam states + history saved by
        ``save``; training continues where it left off. Returns the number
        of epochs already run. The JAX package's orbax checkpoints do not
        load."""
        from ..train.checkpoint import load_checkpoint
        tree, meta = load_checkpoint(checkpoint_path,
                                     target=self.state_tree())
        self._load_state(tree)
        self.best_val_loss = float(meta.get("best_val_loss",
                                            self.best_val_loss))
        self.training_history = meta.get("training_history",
                                         self.training_history)
        epochs_run = int(meta.get("epochs_run", 0))
        self._log(f"Restored TASC checkpoint from {checkpoint_path} "
                  f"({epochs_run} epochs run)")
        return epochs_run

    def train(self, num_epochs: int,
              checkpoint_dir: Optional[str] = None
              ) -> Dict[str, List[float]]:
        for epoch in range(num_epochs):
            t0 = time.time()
            g, d, dec = self.train_epoch()
            val = self.validate()
            self.training_history["epoch_times"].append(time.time() - t0)
            self._log(f"Epoch {epoch + 1}/{num_epochs}: G={g:.4f} D={d:.4f} "
                      f"decoder={dec:.4f} val={val:.4f}")
            if val < self.best_val_loss:
                self.best_val_loss = val
                if checkpoint_dir is not None:
                    path = self.save(checkpoint_dir)
                    self._log(f"New best val loss; saved {path}")
        return self.training_history
