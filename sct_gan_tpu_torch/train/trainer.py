"""SmartContractTrainer of the port: the host loop around the train step.

Counterpart of ``sct_gan_tpu/train/trainer.py`` (parity with the reference
trainer, SCT-GAN/train.py:480-1721): the constructor (parameters on the
device, the optimizer, the train and eval steps, group LRs, the dataset
vulnerability scan and the startup dimension test), ``train_epoch`` with
its first-batch oscillation check, ``validate``, ``train`` (history,
best/latest checkpoints, patience and early stopping, an optional
``torch.profiler`` trace of one epoch), the epoch interventions
(``_epoch_interventions``: stabilisation growth, recall-swing damping, the
focal retune, the dead-line-head LR boosts, the no-prediction emergency,
the plateau scheduler, the LR-floor rescues, the validation-loss
explosion), ``restore`` from a checkpoint of ``train/checkpoint.py``, and
augmentation (``_bank_variants``, ``_create_augmented_batch``). The device
runs the step; the host owns the control decisions, which change runtime
values fed to the step, never the step itself.

``fused_optimizer=False`` takes the unfused chain
(``optimizer.GradientTransform``) in place of ``FusedOptimizer``.

Differences from the JAX trainer:

  * errors propagate. The JAX ``train_epoch`` logs and skips a batch whose
    step raises; here an error of a kernel, of the kernel build or of CUDA
    ends the run. A failed checkpoint write is logged and training goes on,
    as in JAX (``checkpoint.AsyncSaver``);
  * the augmenter draws from ``random.Random(seed)`` (the JAX trainer's is
    unseeded), so one seed gives one run; the trainer's own draws (variant
    counts, bank and pair sampling) come from a second
    ``random.Random(seed)`` in the JAX trainer's order;
  * there is no OOM valve: the JAX loader's ``on_oom`` hook drops queued
    snapshots (``AsyncSaver.drop_pending``); here a snapshot dropped on
    rank 0 alone would part the ranks' checkpoint decisions, which gather
    over mp on every rank. ``parallel.prefetch_to_device`` takes the hook
    for a caller that wants it.

``mesh`` (``parallel.make_mesh``, one process per rank) runs the JAX
trainer's dp × mp layout: the model is sharded by the mp rules
(``SmartContractTransformer.parallelize_``), each batch is padded to a
multiple of dp and each rank takes its rows (``prefetch_to_device``), the
metrics are global (``train_step``), rank 0 writes the checkpoints with the
mp shards gathered, in the single-card format, and ``restore`` cuts a
checkpoint of any layout to this rank's shards. Every rank must see the
same loaders, in the same order, and pass the same seed.
"""
from __future__ import annotations

import collections
import glob
import json
import math
import os
import random
import time
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ..config import TrainConfig
from ..convert import (convert_flax_opt_state, convert_flax_params,
                       flax_opt_state_from_torch, flax_params_from_torch)
from ..data.augmentation import SmartContractAugmenter
from ..losses.syntax import SyntaxLossTables
from ..models.sct_transformer import SmartContractTransformer
from ..parallel.collectives import SINGLE, all_gather, all_reduce_
from ..parallel.mesh import (param_shard, param_shard_dims,
                             prefetch_to_device)
from ..utils import resolve_device
from .checkpoint import (AsyncSaver, adapt_vocab_params, checkpoint_suffix,
                         load_checkpoint, save_checkpoint)
from .optimizer import (FusedOptimizer, GradientTransform, GroupLRs,
                        ReduceLROnPlateau)
from .train_step import (DynamicScalars, TrainState, make_eval_step,
                         make_train_step)

_HISTORY_KEYS = [
    "train_loss", "val_loss", "contract_vuln_loss", "line_vuln_loss",
    "learning_rate", "discriminator_loss", "syntax_loss",
    "line_vuln_accuracy", "line_vuln_precision", "line_vuln_recall",
]
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

    The constructor takes the JAX trainer's arguments and ``device``: the
    card (``"cuda"``) by default; without one it raises unless
    ``device="cpu"`` is passed. With ``mesh`` the mesh's device is the
    rank's and ``device`` is not read. The model's f32 parameters move to
    the device (this rank's shards of them) and are trained in place.

    Train, resume and serve::

        trainer.train(num_epochs, checkpoint_dir="ckpt")
        trainer.restore("ckpt/latest_model_gan")     # a fresh trainer
        SmartContractAnalyzer("ckpt/best_model_gan_epoch_3")
    """

    # one card unless the constructor is given a mesh
    mesh = None
    _dp = _mp = SINGLE

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
        mesh=None,
    ):
        cfg = config or TrainConfig(
            learning_rate=learning_rate, weight_decay=weight_decay,
            max_grad_norm=max_grad_norm, use_augmentation=use_augmentation,
            use_gan=use_gan)
        self.cfg = cfg
        self.mesh = mesh
        self._dp = SINGLE if mesh is None else mesh.axis("dp")
        self._mp = SINGLE if mesh is None else mesh.axis("mp")
        # parameter name -> its dim split over mp (None: whole)
        self._shard_dims: Dict[str, Optional[int]] = {}
        if mesh is None:
            self.device = resolve_device(device)
            self.model = model.to(self.device)
        else:
            self.device = mesh.device
            self.model = model.parallelize_(mesh)
            self._shard_dims = param_shard_dims(model.config, mesh)
        self._rank0 = mesh is None or (self._dp.rank == 0
                                       and self._mp.rank == 0)
        self.tokenizer = tokenizer
        self.train_dataloader = train_dataloader
        self.val_dataloader = val_dataloader
        self.use_augmentation = cfg.use_augmentation
        self.use_gan = cfg.use_gan
        self._log = (print if verbose and self._rank0
                     else (lambda *a, **k: None))
        # the seeds of every dropout site are drawn from this, on the host
        self.generator = torch.Generator().manual_seed(seed)
        self._py_rng = random.Random(seed)
        # pre-tokenized augmentation variants, keyed by contract source
        # (see _bank_variants; TrainConfig.aug_bank_size)
        self._aug_bank: Dict[str, List[np.ndarray]] = {}
        self._saver = AsyncSaver(log=self._log)

        # -- optimizer + steps -----------------------------------------------
        named = list(model.named_parameters())
        opt_cls = FusedOptimizer if cfg.fused_optimizer else GradientTransform
        self.optimizer = opt_cls(
            named, use_gan=self.use_gan, max_grad_norm=cfg.max_grad_norm,
            adam_b1=cfg.adam_b1, adam_b2=cfg.adam_b2, adam_eps=cfg.adam_eps,
            weight_decay=cfg.weight_decay, mp=self._mp,
            sharded=[n for n, d in self._shard_dims.items()
                     if d is not None])
        self.state = TrainState(dict(named), self.optimizer.init(), 0)
        self.syntax_tables = SyntaxLossTables.from_tokenizer(tokenizer)
        self.train_step = make_train_step(
            model, self.optimizer, self.syntax_tables, use_gan=self.use_gan,
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

        # -- augmentation ------------------------------------------------------
        self.augmenter = (SmartContractAugmenter(
            getattr(tokenizer, "name_or_path", "tokenizer"),
            tokenizer=tokenizer, seed=seed) if self.use_augmentation else None)

        # -- dataset vulnerability scan (train.py:623-705) -------------------
        self._scan_dataset()

        # -- adaptive-control state (train.py:669-705) -----------------------
        self.current_epoch = 0
        self.warmup_epochs = cfg.warmup_epochs
        self.prev_line_recall = 0.0
        self.prev_line_precision = 0.0
        self.stability_factor = 1.0
        self.prev_line_logit_mean = 0.0
        self.prev_line_logit_std = 0.0
        self.oscillation_detected = False
        self.consecutive_oscillations = 0
        self.line_loss_scale = 1.0
        self.min_line_loss_scale = 0.1
        self.max_line_loss_scale = 5.0
        self.loss_warmup_epochs = 5
        self.total_line_predictions = 0.0
        self.batches_with_predictions = 0
        self.contract_vuln_weight = 3.0
        self.spatial_alpha = 0.25
        self.spatial_gamma = 2.0
        self.spatial_weight = 0.2

        self.best_val_loss = float("inf")
        # last best val loss durably written to disk: the rollback target
        # when a queued best snapshot is dropped before its write
        self._persisted_best_val = float("inf")
        self.patience_counter = 0
        self.patience = cfg.patience
        self.training_history: Dict[str, List[float]] = {
            k: [] for k in _HISTORY_KEYS}

        self._dimension_smoke_test(model.config.max_length)

    # ------------------------------------------------------------------
    def _whole(self, named: Dict[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
        """Parameter-shaped tensors by name, each sharded one gathered
        over mp (every rank must call it); the others as they are."""
        out = {}
        for name, t in named.items():
            d = self._shard_dims.get(name)
            if d is not None:
                t = all_gather(t.transpose(0, d), self._mp).transpose(0, d)
            out[name] = t
        return out

    def _local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the whole parameter-shaped ``t``."""
        return param_shard(t, self._shard_dims.get(name), self._mp)

    def state_tree(self, params_only: bool = False) -> Dict:
        """The train state in flax naming, as a checkpoint holds it: views
        of the live tensors (no copy; under mp the sharded ones gathered,
        on every rank), ``opt_state`` unless ``params_only``."""
        cfg = self.model.config
        tree = {"params": flax_params_from_torch(
                    self._whole(self.state.params), cfg),
                "step": np.asarray(self.state.step, np.int32)}
        if not params_only:
            opt = self.state.opt_state
            tree["opt_state"] = flax_opt_state_from_torch(
                {"count": opt["count"], "mu": self._whole(opt["mu"]),
                 "nu": self._whole(opt["nu"])}, cfg)
        return tree

    def _load_state(self, tree: Dict, fresh_opt: bool) -> None:
        """Copy a checkpoint's params (and opt state) into the live
        tensors in place: the optimizer and the train step hold them."""
        cfg = self.model.config
        sd = convert_flax_params(tree["params"], cfg)
        with torch.no_grad():
            for name, p in self.state.params.items():
                p.copy_(self._local(name, sd[name]))
        if fresh_opt:
            opt_state = self.optimizer.init()
        else:
            src = convert_flax_opt_state(tree["opt_state"], cfg)
            opt_state = self.state.opt_state
            opt_state["count"] = src["count"].to(self.device)
            for key in ("mu", "nu"):
                for name, t in opt_state[key].items():
                    t.copy_(self._local(name, src[key][name]))
        self.state = TrainState(self.state.params, opt_state,
                                int(tree["step"]))

    def restore(self, checkpoint_path: str) -> int:
        """Resume from a checkpoint saved by ``train``: params, optimizer
        state, step counter, group LRs, plateau-scheduler state and
        training history (the reference's resume flow incl. optimizer
        state, Model-v3/trainning-phase.ipynb cells 11-12). Returns the
        epoch to continue from.

        The sidecar's ``params_only`` picks the case: a params-only (best)
        checkpoint resumes with a fresh optimizer; a full one restores the
        optimizer too. Without a sidecar the full state is tried, then the
        params alone. Only a shape or structure mismatch of the params
        falls back to adapting the vocab-sized leaves (a checkpoint saved
        under another ``vocab_pad_multiple``) with a fresh optimizer; any
        other load error propagates."""
        full_target = self.state_tree()
        slim_target = self.state_tree(params_only=True)

        def _vocab_fallback():
            tree, meta = load_checkpoint(checkpoint_path)
            tree["params"] = adapt_vocab_params(
                tree["params"], self.model.config.padded_vocab_size)
            self._log("checkpoint vocab padding differs from the model's: "
                      "adapted embedding/LM-head shapes; resuming with a "
                      "freshly initialized optimizer")
            return tree, meta

        def _is_shape_mismatch(e: Exception) -> bool:
            msg = str(e).lower()
            return "shape" in msg or "structure" in msg

        meta_path = os.path.abspath(checkpoint_path) + ".meta.json"
        params_only = None
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                params_only = bool(json.load(f).get("params_only", False))

        if params_only is True:
            try:
                tree, meta = load_checkpoint(checkpoint_path,
                                             target=slim_target)
            except ValueError as e:
                if not _is_shape_mismatch(e):
                    raise
                tree, meta = _vocab_fallback()
            fresh = True
            self._log("checkpoint is params-only (best): resuming with a "
                      "freshly initialized optimizer")
        elif params_only is False:
            try:
                tree, meta = load_checkpoint(checkpoint_path,
                                             target=full_target)
                fresh = False
            except ValueError as e:
                if not _is_shape_mismatch(e):
                    raise
                tree, meta = _vocab_fallback()
                fresh = True
        else:
            try:
                tree, meta = load_checkpoint(checkpoint_path,
                                             target=full_target)
                fresh = False
            except ValueError as e:
                if not _is_shape_mismatch(e):
                    raise
                try:
                    tree, meta = load_checkpoint(checkpoint_path,
                                                 target=slim_target)
                except ValueError as e2:
                    if not _is_shape_mismatch(e2):
                        raise
                    tree, meta = _vocab_fallback()
                fresh = True
                self._log("checkpoint has no optimizer state (params-only "
                          "best): resuming with a freshly initialized "
                          "optimizer")
        self._load_state(tree, fresh)
        if meta:
            self.best_val_loss = float(meta.get("val_loss",
                                                self.best_val_loss))
            self.training_history = meta.get("training_history",
                                             self.training_history)
            if "lrs" in meta:
                self.lrs = {k: float(v) for k, v in meta["lrs"].items()}
            if "scheduler" in meta:
                self.scheduler.load_state_dict(meta["scheduler"])
            self.current_epoch = int(meta.get("epoch", 0))
        self._log(f"Restored checkpoint from {checkpoint_path} "
                  f"(epoch {self.current_epoch})")
        return self.current_epoch

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

    # ------------------------------------------------------------------
    def _bank_variants(self, code: str, n: int) -> List[np.ndarray]:
        """Up to ``n`` tokenized variant-target rows for one contract.

        With ``aug_bank_size > 0`` the regex transforms and the
        tokenization run once per contract, building a bank of tokenized
        variants that later epochs sample rows from; ``aug_bank_size == 0``
        regenerates fresh variants every time (the reference's semantics,
        SCT-GAN/train.py:774-866)."""
        max_len = self.model.config.max_length

        def _tok_rows(texts: List[str]) -> List[np.ndarray]:
            enc = self.tokenizer(texts, max_length=max_len,
                                 padding="max_length", truncation=True,
                                 return_tensors="np")
            ids = np.asarray(enc["input_ids"], np.int32)
            return [ids[i] for i in range(ids.shape[0])]

        bank_size = self.cfg.aug_bank_size
        if bank_size <= 0:
            pairs = self.augmenter.augment_contract(code, n)
            return _tok_rows([v for _, v in pairs]) if pairs else []
        bank = self._aug_bank.get(code)
        if bank is None:
            pairs = self.augmenter.augment_contract(code, bank_size)
            bank = _tok_rows([v for _, v in pairs]) if pairs else []
            self._aug_bank[code] = bank
        if not bank:
            return []
        k = min(n, len(bank))
        return [bank[i] for i in self._py_rng.sample(range(len(bank)), k)]

    def _create_augmented_batch(self, batch: Dict) -> Dict:
        """Host-side augmented batch (train.py:774-866): 2–3 variants per
        contract, resampled to the batch size, dummy AST = the input. The
        pair's input side is the original contract, so input rows are
        reused from the tokenized batch and only the variant targets are
        tokenized (from the bank). Labels follow each pair's source
        contract with ``aug_label_correct``, else the reference's batch
        slot (train.py:829-839)."""
        if not self.use_augmentation or "source_code" not in batch:
            return batch
        source_codes = batch["source_code"]

        pairs = []   # (contract index in batch, variant target ids row)
        for ci, code in enumerate(source_codes):
            n = self._py_rng.randint(2, 3)
            pairs.extend((ci, row) for row in self._bank_variants(code, n))
        if not pairs:
            return batch
        if len(pairs) > len(source_codes):
            pairs = self._py_rng.sample(pairs, len(source_codes))
        # keep the batch size: fill up by repeating pairs
        while len(pairs) < len(source_codes):
            pairs.append(pairs[len(pairs) % max(len(pairs), 1)])

        src = np.asarray([ci for ci, _ in pairs], np.int64)
        target_ids = np.stack([row for _, row in pairs])
        input_ids = np.asarray(batch["input_ids"])[src]
        attention_mask = np.asarray(batch["attention_mask"])[src]
        n = len(pairs)
        if self.cfg.aug_label_correct:
            idx = src
        else:
            idx = np.minimum(np.arange(n), len(source_codes) - 1)
        return {
            "input_ids": input_ids,
            "attention_mask": attention_mask,
            "ast_input_ids": input_ids,
            "ast_attention_mask": attention_mask,
            "target_ids": target_ids,
            "vulnerable_lines": np.asarray(batch["vulnerable_lines"])[idx],
            "contract_vulnerabilities":
                np.asarray(batch["contract_vulnerabilities"])[idx],
            "token_to_line": np.asarray(batch["token_to_line"])[idx],
        }

    def _pad_to_dp(self, batch: Dict) -> Dict:
        """Pad every batch to one size (the largest batch size seen).

        Padding rows repeat the last real row but carry ``row_valid=0``, so
        the loss and metric masking of ``compute_losses`` gives them zero
        weight: a padded tail batch yields the loss, gradients and metrics
        of the unpadded batch. The size is a multiple of dp, so that each
        rank takes an equal share of the rows."""
        dp = self._dp.size
        b = batch["input_ids"].shape[0]
        target = max(self._static_batch, dp * math.ceil(b / dp))
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

    def _prepare(self, batch: Dict) -> Dict:
        """A loader's batch, augmented and padded, on the host."""
        if self.use_augmentation:
            batch = self._create_augmented_batch(batch)
        return self._pad_to_dp(batch)

    def _device_batches(self, loader):
        """The loader's batches as the step takes them: on one card each
        copied in turn; on a mesh this rank's rows, prefetched."""
        if self.mesh is None:
            return (self.to_device(self._prepare(b)) for b in loader)
        # no OOM valve here: a snapshot dropped on rank 0 alone would part
        # the ranks' checkpoint decisions, which gather collectively
        return prefetch_to_device(loader, self.mesh, prepare=self._prepare)

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
        for batch_idx, device_batch in enumerate(self._device_batches(
                self.train_dataloader)):
            self.state, metrics, scalars = self.train_step(
                self.state, device_batch, scalars, lrs, self.generator)
            ntokens = device_batch["input_ids"].numel() * self._dp.size
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

    def _select_val(self, val_metrics: Dict[str, float]) -> float:
        """The scalar that picks checkpoints, counts patience and drives
        the plateau scheduler: the validation gen loss (train.py:1657-1658),
        or with ``model_select="detection"`` the contract + line focal
        losses."""
        if self.cfg.model_select == "detection":
            return (val_metrics["contract_vuln_loss"]
                    + val_metrics["line_vuln_loss"])
        return val_metrics["gen_loss"]

    def validate(self) -> Dict[str, float]:
        """The validation losses over the val loader (eval-mode forward, no
        discriminator term). At most 2 steps are in flight: the host
        prepares batch i+1 while the card runs batch i, and reads a step's
        metrics once a third is queued."""
        warmup_factor = min(1.0, (self.current_epoch + 1) / self.warmup_epochs)
        scalars = self._scalars(warmup_factor, for_validation=True)
        sums: Dict[str, float] = {}
        batch_count = 0
        pending = collections.deque()

        def _fetch_one():
            nonlocal batch_count
            m = _fetch_metrics(pending.popleft())
            for k in ("gen_loss", "contract_vuln_loss", "line_vuln_loss"):
                sums[k] = sums.get(k, 0.0) + m[k]
            batch_count += 1

        for device_batch in self._device_batches(self.val_dataloader):
            pending.append(self.eval_step(device_batch, scalars))
            if len(pending) > 2:
                _fetch_one()
        while pending:
            _fetch_one()
        out = {k: (sums.get(k, 0.0) / batch_count if batch_count else
                   float("inf"))
               for k in ("gen_loss", "contract_vuln_loss", "line_vuln_loss")}
        out["discriminator_loss"] = 0.0
        return out

    # ------------------------------------------------------------------
    def train(self, num_epochs: int, checkpoint_dir: str = "checkpoints",
              profile_dir: Optional[str] = None,
              profile_epoch: int = 1,
              stop: Optional[Callable[[int], bool]] = None
              ) -> Dict[str, List[float]]:
        """Run the training loop; returns the history. ``profile_dir``
        writes a ``torch.profiler`` trace of epoch ``profile_epoch``
        (``utils.profiling.trace_context``). ``stop``, the port's own, is
        called after each epoch's checkpoints with the number of epochs
        run; True ends the loop there, as if ``num_epochs`` had been
        that number (under a mesh it must answer alike on every rank)."""
        os.makedirs(checkpoint_dir, exist_ok=True)
        suffix = checkpoint_suffix(self.use_augmentation, self.use_gan)

        for epoch in range(num_epochs):
            self._log(f"\nEpoch {epoch + 1}/{num_epochs}")
            self.current_epoch = epoch
            t_train0 = time.time()
            if profile_dir is not None and epoch == profile_epoch:
                from ..utils.profiling import trace_context
                with trace_context(profile_dir):
                    train_metrics = self.train_epoch(epoch)
            else:
                train_metrics = self.train_epoch(epoch)
            t_val0 = time.time()
            val_metrics = self.validate()
            t_val1 = time.time()

            h = self.training_history
            h["train_loss"].append(train_metrics["gen_loss"])
            h["val_loss"].append(val_metrics["gen_loss"])
            h["contract_vuln_loss"].append(train_metrics["contract_vuln_loss"])
            h["line_vuln_loss"].append(train_metrics["line_vuln_loss"])
            h["learning_rate"].append(self.lrs["base"])
            h["line_vuln_accuracy"].append(train_metrics["line_vuln_accuracy"])
            h["line_vuln_precision"].append(
                train_metrics["line_vuln_precision"])
            h["line_vuln_recall"].append(train_metrics["line_vuln_recall"])
            h["discriminator_loss"].append(
                train_metrics["discriminator_loss"] if self.use_gan else 0.0)
            h["syntax_loss"].append(train_metrics["syntax_loss"])

            select_val = self._select_val(val_metrics)
            self._log(f"Train Loss: {train_metrics['gen_loss']:.4f}  "
                      f"Val Loss: {val_metrics['gen_loss']:.4f}  "
                      + (f"Select: {select_val:.5f}  "
                         if self.cfg.model_select != "gen_loss" else "")
                      + f"({train_metrics['tokens_per_sec']:.0f} tok/s; "
                      f"train {t_val0 - t_train0:.1f}s "
                      f"val {t_val1 - t_val0:.1f}s)")

            self._epoch_interventions(epoch, train_metrics, val_metrics)

            # -- checkpointing (train.py:1656-1721) -------------------------
            improved = select_val < self.best_val_loss
            meta = {
                "epoch": epoch + 1,
                "val_loss": select_val,
                "training_history": self.training_history,
                "use_augmentation": self.use_augmentation,
                "use_gan": self.use_gan,
                "line_vuln_accuracy": train_metrics["line_vuln_accuracy"],
                "line_vuln_precision": train_metrics["line_vuln_precision"],
                "line_vuln_recall": train_metrics["line_vuln_recall"],
                "lrs": self.lrs,
                "scheduler": self.scheduler.state_dict(),
            }
            if improved:
                self.best_val_loss = select_val
                self.patience_counter = 0
                best_val = float(select_val)

                def _mark_persisted(v=best_val):
                    self._persisted_best_val = v

                def _rollback_best():
                    # a queued best dropped before its write: later epochs
                    # compete against the best actually on disk
                    self.best_val_loss = self._persisted_best_val
                    self._log("best snapshot dropped before save; "
                              "best_val_loss rolled back to "
                              f"{self.best_val_loss:.4f}")

                # best checkpoints are for evaluation: params only
                self._submit(
                    checkpoint_dir, f"best_model{suffix}_epoch_{epoch + 1}",
                    self.state_tree(params_only=True),
                    dict(meta, params_only=True),
                    on_saved=_mark_persisted, on_dropped=_rollback_best)
                self._log("🎉 New best validation loss! Saving "
                          f"best_model{suffix}_epoch_{epoch + 1} "
                          "(background)")
            else:
                self.patience_counter += 1
                self._log(f"No improvement for {self.patience_counter} "
                          "epochs")

            if self.patience_counter >= self.patience:
                self._log(f"Early stopping after {self.patience} epochs "
                          "without improvement")
                break

            if (epoch + 1) % max(self.cfg.latest_every, 1) == 0:
                self._submit(checkpoint_dir, f"latest_model{suffix}",
                             self.state_tree(), meta)
            if stop is not None and stop(epoch + 1):
                self._log(f"Stopping after epoch {epoch + 1}: the caller's "
                          "stop")
                break
        # the written checkpoints complete before returning
        self._saver.wait()
        # at least one best checkpoint exists (every submit of the run may
        # have been dropped)
        if self._rank0_says(not glob.glob(os.path.join(checkpoint_dir,
                                                        "best_model*"))):
            tree = self.state_tree(params_only=True)
            if self._rank0:
                save_checkpoint(
                    checkpoint_dir,
                    f"best_model{suffix}_epoch_{self.current_epoch + 1}",
                    tree, {"epoch": self.current_epoch + 1,
                           "training_history": self.training_history,
                           "use_augmentation": self.use_augmentation,
                           "use_gan": self.use_gan, "params_only": True})
        return self.training_history

    def _submit(self, checkpoint_dir: str, name: str, tree: Dict,
                meta: Dict, **callbacks) -> None:
        """Queue a checkpoint write: rank 0 writes, the tree having been
        gathered on every rank (``state_tree``)."""
        if self._rank0:
            self._saver.submit(checkpoint_dir, name, tree, meta, **callbacks)

    def _rank0_says(self, flag: bool) -> bool:
        """Rank 0's ``flag``, on every rank of the mesh."""
        if self.mesh is None:
            return flag
        t = torch.tensor([int(flag and self._rank0)], device=self.device)
        all_reduce_(t, self._dp, torch.distributed.ReduceOp.MAX)
        all_reduce_(t, self._mp, torch.distributed.ReduceOp.MAX)
        return bool(t.item())

    # ------------------------------------------------------------------
    def _epoch_interventions(self, epoch: int, train_metrics: Dict,
                             val_metrics: Dict) -> None:
        """Epoch-level self-healing (train.py:1529-1654)."""
        line_recall = train_metrics["line_vuln_recall"]
        line_precision = train_metrics["line_vuln_precision"]

        # stabilization growth (train.py:1529-1546)
        if not self.oscillation_detected and epoch > 2:
            if self.line_loss_scale < 1.0:
                self.line_loss_scale = min(1.0, self.line_loss_scale * 1.2)
            if self.stability_factor < 1.0:
                self.stability_factor = min(1.0, self.stability_factor * 1.1)
        self.oscillation_detected = False

        if epoch > 0:
            # recall-swing damping (train.py:1551-1556)
            if ((self.prev_line_recall > 0.8 and line_recall < 0.1)
                    or (self.prev_line_recall < 0.1 and line_recall > 0.8)):
                self._log("⚠️  Recall oscillation — damping stability factor")
                self.stability_factor = max(0.3, self.stability_factor * 0.7)
            # precision/recall focal retuning (train.py:1558-1568)
            if line_precision < 0.01 and line_recall > 0.8:
                self.spatial_alpha = min(0.5, self.spatial_alpha * 1.2)
                self.spatial_gamma = max(1.5, self.spatial_gamma * 0.9)
            if line_precision > 0.8 and line_recall < 0.1:
                self.spatial_alpha = max(0.1, self.spatial_alpha * 0.8)
                self.spatial_gamma = min(3.0, self.spatial_gamma * 1.1)
        self.prev_line_recall = line_recall
        self.prev_line_precision = line_precision

        # dead-line-head LR boosts (train.py:1574-1585)
        def _cap_line_lr():
            cap = self.cfg.line_lr_max
            if cap is not None and self.lrs["line"] > cap:
                self.lrs["line"] = cap
        if line_recall < 0.01 and epoch > 5:
            self.lrs["line"] *= 2.0
            _cap_line_lr()
            self._log(f"⚠️  Low line recall — boosted line LR to "
                      f"{self.lrs['line']:.2e}")
        if line_recall == 0.0 and epoch > 5:
            self.lrs["line"] *= 2.0
            _cap_line_lr()
            self.line_loss_scale = min(self.max_line_loss_scale,
                                       self.line_loss_scale * 1.5)
            self.stability_factor = min(1.0, self.stability_factor * 1.2)
        # no-prediction emergency (train.py:1604-1621)
        if self.batches_with_predictions == 0 and epoch > 5:
            self._log("🚨  No line predictions in any batch — emergency "
                      "boost")
            self.lrs["line"] *= 3.0
            _cap_line_lr()
            self.line_loss_scale = min(self.max_line_loss_scale,
                                       self.line_loss_scale * 2.0)
            self.stability_factor = 0.8
        self.total_line_predictions = 0.0
        self.batches_with_predictions = 0

        # plateau scheduler on the model-selection signal (train.py:1628)
        self.lrs, reduced = self.scheduler.step(self._select_val(val_metrics),
                                                self.lrs)
        if reduced:
            self._log(f"Plateau: reduced LRs to base {self.lrs['base']:.2e}")

        # LR-floor rescues (train.py:1631-1645)
        if self.lrs["base"] < 1e-6 and self.patience_counter > 10:
            self._log("🚨 LR critically low — boosting to 5e-5")
            self.lrs = {k: 5e-5 for k in self.lrs}
            self.patience_counter = 0
        elif self.lrs["base"] < 1e-6 and self.patience_counter > 5:
            self._log("⚠️  LR too small — boosting to 1e-5")
            self.lrs = {k: 1e-5 for k in self.lrs}
            self.patience_counter = 0

        # val-loss explosion (train.py:1647-1654)
        if self._select_val(val_metrics) > self.best_val_loss * 2.0:
            self._log("⚠️  Validation loss explosion — cutting LR 10×")
            self.lrs = {k: v * 0.1 for k, v in self.lrs.items()}
            self.patience_counter = 0
