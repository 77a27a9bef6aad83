"""SmartContractTrainer of the port: the host loop around the train step.

Counterpart of ``sct_gan_tpu/train/trainer.py`` (parity with the reference
trainer, SCT-GAN/train.py:480-1721) for the training slice: the
constructor (parameters on the device, ``FusedOptimizer``, the train and
eval steps, group LRs, the dataset vulnerability scan and the startup
dimension test), ``_scalars``, ``_group_lrs``, ``_pad_to_dp`` and
``train_epoch`` with its first-batch oscillation check. The device runs the
step; the host owns the control decisions, which change runtime values fed
to the step, never the step itself.

Not ported yet: augmentation, ``validate`` / ``train``, the epoch
interventions and the plateau scheduler's use, checkpoints, and the optax
chain (``fused_optimizer=False``). Asking for one of them raises.

Errors propagate. The JAX ``train_epoch`` logs and skips a batch whose step
raises; here an error of a kernel, of the kernel build or of CUDA ends the
run.
"""
from __future__ import annotations

import math
import time
from typing import Dict, Optional, Union

import numpy as np
import torch

from ..config import TrainConfig
from ..losses.syntax import SyntaxLossTables
from ..models.sct_transformer import SmartContractTransformer
from ..utils import resolve_device
from .optimizer import FusedOptimizer, GroupLRs, ReduceLROnPlateau
from .train_step import (DynamicScalars, TrainState, make_eval_step,
                         make_train_step)

_MODEL_KEYS = ("input_ids", "attention_mask", "ast_input_ids",
               "ast_attention_mask", "token_to_line", "vulnerable_lines",
               "contract_vulnerabilities", "target_ids", "row_valid")


def _fetch_metrics(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """All of a step's metrics in one device-to-host copy."""
    keys = list(metrics)
    vec = torch.stack([metrics[k].float() for k in keys]).cpu().numpy()
    return {k: float(vec[i]) for i, k in enumerate(keys)}


class SmartContractTrainer:
    """Train the SmartContractTransformer with the reference's GAN recipe.

    The constructor takes the JAX trainer's arguments, with ``device`` in
    place of its mesh: the card (``"cuda"``) by default; without one it
    raises unless ``device="cpu"`` is passed. The model's f32 parameters
    move to the device and are trained in place."""

    def __init__(
        self,
        model: SmartContractTransformer,
        train_dataloader,
        val_dataloader,
        tokenizer,
        learning_rate: float = 1e-6,
        weight_decay: float = 0.1,
        max_grad_norm: float = 1.0,
        use_augmentation: bool = False,
        use_gan: bool = False,
        config: Optional[TrainConfig] = None,
        device: Union[str, torch.device] = "cuda",
        seed: int = 0,
        verbose: bool = True,
    ):
        cfg = config or TrainConfig(
            learning_rate=learning_rate, weight_decay=weight_decay,
            max_grad_norm=max_grad_norm, use_augmentation=use_augmentation,
            use_gan=use_gan)
        if cfg.use_augmentation:
            raise NotImplementedError(
                "augmentation is not ported yet (use_augmentation=False)")
        if not cfg.fused_optimizer:
            raise NotImplementedError(
                "the port has only the fused optimizer (fused_optimizer=True)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.tokenizer = tokenizer
        self.train_dataloader = train_dataloader
        self.val_dataloader = val_dataloader
        self.use_augmentation = cfg.use_augmentation
        self.use_gan = cfg.use_gan
        self._log = print if verbose else (lambda *a, **k: None)
        # the seeds of every dropout site are drawn from this, on the host
        self.generator = torch.Generator().manual_seed(seed)

        # -- optimizer + steps -----------------------------------------------
        named = list(model.named_parameters())
        self.fused_opt = FusedOptimizer(
            named, use_gan=self.use_gan, max_grad_norm=cfg.max_grad_norm,
            adam_b1=cfg.adam_b1, adam_b2=cfg.adam_b2, adam_eps=cfg.adam_eps,
            weight_decay=cfg.weight_decay)
        self.state = TrainState(dict(named), self.fused_opt.init(), 0)
        self.syntax_tables = SyntaxLossTables.from_tokenizer(tokenizer)
        self.train_step = make_train_step(
            model, self.fused_opt, self.syntax_tables, use_gan=self.use_gan,
            use_augmentation=self.use_augmentation,
            fused_lm_ce=cfg.fused_lm_ce)
        self.eval_step = make_eval_step(
            model, self.syntax_tables, use_gan=self.use_gan,
            use_augmentation=self.use_augmentation,
            fused_lm_ce=cfg.fused_lm_ce)

        # -- group LRs (train.py:530-540) + scheduler ------------------------
        lr = cfg.learning_rate
        if lr > 1e-4:  # reference guard (train.py:596-600)
            self._log("WARNING: Learning rate is too high! Setting to 1e-4")
            lr = 1e-4
        self.lrs: Dict[str, float] = {
            "base": lr,
            "contract": lr * cfg.contract_head_lr_mult,
            "line": lr * cfg.line_head_lr_mult,
            "disc": lr * cfg.discriminator_lr_mult,
        }
        self.scheduler = ReduceLROnPlateau(
            factor=cfg.plateau_factor, patience=cfg.plateau_patience,
            min_lr=cfg.plateau_min_lr)
        # every batch pads up to the loader's batch size (_pad_to_dp)
        self._static_batch = getattr(train_dataloader, "batch_size", 0) or 0

        # -- dataset vulnerability scan (train.py:623-705) -------------------
        self._scan_dataset()

        # -- adaptive-control state (train.py:669-705) -----------------------
        self.current_epoch = 0
        self.warmup_epochs = cfg.warmup_epochs
        self.stability_factor = 1.0
        self.prev_line_logit_mean = 0.0
        self.prev_line_logit_std = 0.0
        self.oscillation_detected = False
        self.consecutive_oscillations = 0
        self.line_loss_scale = 1.0
        self.min_line_loss_scale = 0.1
        self.loss_warmup_epochs = 5
        self.total_line_predictions = 0.0
        self.batches_with_predictions = 0
        self.contract_vuln_weight = 3.0
        self.spatial_alpha = 0.25
        self.spatial_gamma = 2.0
        self.spatial_weight = 0.2

        self._dimension_smoke_test(model.config.max_length)

    # ------------------------------------------------------------------
    def _scan_dataset(self) -> None:
        total_contracts = 0
        total_contract_vulns = 0.0
        total_line_vulns = 0.0
        for batch in self.train_dataloader:
            total_contracts += batch["contract_vulnerabilities"].shape[0]
            total_contract_vulns += float(
                batch["contract_vulnerabilities"].sum())
            total_line_vulns += float(batch["vulnerable_lines"].sum())
        self.contract_vuln_rate = (total_contract_vulns / total_contracts
                                   if total_contracts else 0.0)
        seq = self.model.config.max_length
        ntypes = self.model.config.num_vulnerability_types
        self.line_vuln_rate = (total_line_vulns
                               / (total_contracts * seq * ntypes)
                               if total_contracts else 0.0)
        # dynamic weight thresholds (train.py:694-703)
        if self.line_vuln_rate < 0.001:
            self.line_vuln_weight = 5.0
        elif self.line_vuln_rate < 0.01:
            self.line_vuln_weight = 3.0
        else:
            self.line_vuln_weight = 2.0
        self._log(f"Dataset: {total_contracts} contracts, "
                  f"line vuln rate {self.line_vuln_rate:.6f}, "
                  f"line weight {self.line_vuln_weight}")

    @torch.no_grad()
    def _dimension_smoke_test(self, max_len: int) -> None:
        """Startup dimension test (train.py:709-772): a dummy batch of 2
        through the full eval-mode forward; check the head shapes."""
        nt = self.model.config.num_vulnerability_types
        ones = torch.ones(2, max_len, dtype=torch.long, device=self.device)
        self.model.eval()
        out = self.model(ones, ones, ones, ones, target_ids=ones,
                         token_to_line=torch.zeros_like(ones))
        cshape = tuple(out["contract_vulnerability_logits"].shape)
        lshape = tuple(out["line_vulnerability_logits"].shape)
        if cshape != (2, nt):
            raise ValueError(f"contract head shape {cshape} != (2, {nt})")
        if lshape != (2, self.model.config.max_lines, nt):
            raise ValueError(f"line head shape {lshape} != "
                             f"(2, {self.model.config.max_lines}, {nt})")
        self._log("✓ Model dimension test passed")

    # ------------------------------------------------------------------
    def _scalars(self, warmup_factor: float, for_validation: bool = False
                 ) -> DynamicScalars:
        if for_validation:
            w_l = self.line_vuln_weight * warmup_factor
        else:
            w_l = (self.line_vuln_weight * warmup_factor
                   * self.stability_factor * self.line_loss_scale)
        return DynamicScalars.make(w_l, self.contract_vuln_weight,
                                   self.spatial_alpha, self.spatial_gamma,
                                   self.spatial_weight, self.device)

    def _group_lrs(self) -> GroupLRs:
        return GroupLRs(self.lrs["base"], self.lrs["contract"],
                        self.lrs["line"], self.lrs["disc"])

    def _pad_to_dp(self, batch: Dict) -> Dict:
        """Pad every batch to one size (the largest batch size seen).

        Padding rows repeat the last real row but carry ``row_valid=0``, so
        the loss and metric masking of ``compute_losses`` gives them zero
        weight: a padded tail batch yields the loss, gradients and metrics
        of the unpadded batch. The port runs on one card, so the data-
        parallel multiple of the JAX trainer is 1."""
        b = batch["input_ids"].shape[0]
        target = max(self._static_batch, b)
        self._static_batch = target
        if b == target and "row_valid" not in batch:
            return batch        # full batch: masked and plain means agree
        pad = target - b
        row_valid = np.zeros(target, dtype=np.float32)
        row_valid[:b] = 1.0
        out = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray):
                out[k] = np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
            else:
                out[k] = v
        out["row_valid"] = row_valid
        return out

    def to_device(self, batch: Dict) -> Dict[str, torch.Tensor]:
        """The model's arrays of a host batch as tensors on the device
        (integers as int64, as the model's index ops take them)."""
        out = {}
        for k, v in batch.items():
            if k in _MODEL_KEYS:
                a = np.asarray(v)
                out[k] = torch.from_numpy(
                    a.astype(np.int64) if a.dtype.kind in "iu" else a
                ).to(self.device)
        return out

    # ------------------------------------------------------------------
    def train_epoch(self, epoch: int) -> Dict[str, float]:
        self.current_epoch = epoch
        warmup_factor = min(1.0, (epoch + 1) / self.warmup_epochs)
        scalars = self._scalars(warmup_factor)
        lrs = self._group_lrs()

        sums: Dict[str, float] = {}
        batch_count = 0
        last: Dict[str, float] = {}
        t0 = time.time()
        tokens = 0

        def process(batch_idx: int, metrics, ntokens: int):
            """Host bookkeeping of one step's metrics (may run one batch
            late, see below)."""
            nonlocal scalars, batch_count, last, tokens
            m = _fetch_metrics(metrics)
            tokens += ntokens
            # first-batch oscillation detection (train.py:1015-1041)
            if batch_idx == 0:
                cur_mean = m["line_logits_mean"]
                cur_std = m["line_logits_std"]
                if epoch >= self.loss_warmup_epochs:
                    if epoch > 0:
                        mean_change = abs(cur_mean - self.prev_line_logit_mean)
                        std_change = abs(cur_std - self.prev_line_logit_std)
                        if ((mean_change > 5.0 or std_change > 1.0)
                                and not self.oscillation_detected):
                            self._log(f"⚠️  OSCILLATION DETECTED! mean Δ"
                                      f"{mean_change:.3f} std Δ{std_change:.3f}")
                            self.oscillation_detected = True
                            self.consecutive_oscillations += 1
                            self.line_loss_scale = max(
                                self.min_line_loss_scale,
                                self.line_loss_scale * 0.5)
                            self.stability_factor = max(
                                0.5, self.stability_factor * 0.7)
                            # keep the step's focal retune, refresh the weight
                            scalars = scalars._replace(
                                line_vuln_weight=self._scalars(
                                    warmup_factor).line_vuln_weight)
                    self.prev_line_logit_mean = cur_mean
                    self.prev_line_logit_std = cur_std
                else:
                    self.line_loss_scale = 1.0

            self.total_line_predictions += m["line_predictions"]
            if m["line_predictions"] > 0:
                self.batches_with_predictions += 1

            # NaN/Inf-loss batches are skipped on the device (no update,
            # train.py:1301-1309) and left out of the epoch averages here
            if m.get("skipped", 0.0) > 0.0 or not math.isfinite(
                    m["total_loss"]):
                self._log(f"⚠️  Skipping batch {batch_idx}: non-finite loss "
                          f"or exploding grads (grad_norm="
                          f"{m.get('grad_norm', float('nan')):.1f})")
                return
            for k in ("gen_loss", "contract_vuln_loss", "line_vuln_loss",
                      "discriminator_loss", "syntax_loss"):
                sums[k] = sums.get(k, 0.0) + m[k]
            batch_count += 1
            last = m

        # The metrics of batch i are read only after batch i+1's step is
        # queued, so the card does not wait on the host's bookkeeping.
        # Batch 0 is read at once: its metrics drive the oscillation check,
        # which must apply from batch 1 on (train.py:1015-1041).
        pending = None
        for batch_idx, batch in enumerate(self.train_dataloader):
            device_batch = self.to_device(self._pad_to_dp(batch))
            self.state, metrics, scalars = self.train_step(
                self.state, device_batch, scalars, lrs, self.generator)
            ntokens = device_batch["input_ids"].numel()
            if batch_idx == 0:
                process(0, metrics, ntokens)
            else:
                if pending is not None:
                    process(*pending)
                pending = (batch_idx, metrics, ntokens)
        if pending is not None:
            process(*pending)

        # the per-batch focal retune back to the host state, so epoch
        # interventions compose with it (train.py:1172-1182 ordering)
        if batch_count:
            self.spatial_alpha = float(scalars.spatial_alpha)
            self.spatial_gamma = float(scalars.spatial_gamma)
            self.spatial_weight = float(scalars.spatial_weight)

        dt = max(time.time() - t0, 1e-9)
        out = {k: (sums.get(k, 0.0) / batch_count if batch_count else
                   float("inf"))
               for k in ("gen_loss", "contract_vuln_loss", "line_vuln_loss",
                         "discriminator_loss", "syntax_loss")}
        out["line_vuln_accuracy"] = last.get("line_vuln_accuracy", 0.0)
        out["line_vuln_precision"] = last.get("line_vuln_precision", 0.0)
        out["line_vuln_recall"] = last.get("line_vuln_recall", 0.0)
        out["tokens_per_sec"] = tokens / dt
        out["step_time_ms"] = dt / max(batch_count, 1) * 1e3
        out["batches"] = batch_count
        return out
