"""The training and validation steps of the port: ``sct_gan_tpu/train/train_step.py``.

One step is the forward (every head and the GAN discriminator), the full
loss mix, the backward and ``FusedOptimizer``. Everything the reference
mutates between batches (loss weights, focal α/γ, group LRs) enters as
runtime values, and the per-batch focal retune comes back as device
scalars, so a step reads nothing back to the host.

Loss-mix parity (SCT-GAN/train.py:1243-1270):
    aug+gan : 0.5·gen + 0.25·contract·w_c + 0.2·line·w_l + 0.05·disc [+0.02·adv]
    aug     : 0.6·gen + 0.25·contract·w_c + 0.15·line·w_l
    plain   : 0.5·gen + 0.3·contract·w_c + 0.2·line·w_l [+ GAN terms]
with loss floors (contract 1e-4, line 1e-6) and the high-line-loss
down-scaling (×0.1 above 5.0, ×0.5 above 1.0; train.py:1184-1194).

GAN terms (train.py:1201-1234): disc BCE toward "real", overconfidence
penalties (conf > 0.8: +1.0·E[σ²] + 2.0·E[σ⁴]), and a 0.02-weighted
adversarial term active only when conf < 0.3.

Dropout: in a training step every dropout site draws its seed from the
``torch.Generator`` handed to the step. Flax derives a key per site from the
step's rng instead, so a step with dropout on draws other masks than the
JAX step does; with dropout off (``deterministic=True``) the two agree.

Under a mesh (``model.mesh``, set by ``parallelize_``) every mean the JAX
step takes over the global batch stays global: each rank forwards its dp
rows, the small per-row outputs (contract, line and discriminator logits)
and labels are gathered over dp (``gather_rows``: each rank's gradient is
its share), so every loss, quantile and metric is computed on the global
batch, identically on every rank; the LM cross-entropy, fused or not, is
this rank's summed NLL over the global count, all-reduced for its value
(the unfused logits are gathered over mp only, never over dp). The parameter
gradients are then summed over dp. Every generator of the ranks must be
seeded alike: they draw the same seeds, and each rank's masks are its slice
of the single-card masks.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from ..losses.focal import (binary_cross_entropy_with_logits,
                            contract_level_focal_loss, masked_mean,
                            spatial_aware_focal_loss)
from ..losses.syntax import (SyntaxLossTables, cross_entropy_loss,
                             syntax_penalty)
from ..ops.fused_ce import fused_linear_cross_entropy
from ..parallel.collectives import (SINGLE, all_gather, all_reduce_,
                                    gather_rows)
from .optimizer import FusedOptimizer, GroupLRs


class TrainState(NamedTuple):
    """The parameters (the model's own, by name), the optimizer state and
    the step count. The step updates the parameters and the optimizer
    state in place, as the JAX step donates its input state."""

    params: Dict[str, torch.Tensor]
    opt_state: Any
    step: int


class DynamicScalars(NamedTuple):
    """Host-mutated runtime scalars fed to every step: 0-dim f32 tensors on
    the step's device."""

    line_vuln_weight: torch.Tensor      # warmup·stability·scale adjusted
    contract_vuln_weight: torch.Tensor  # 3.0 (train.py:705)
    spatial_alpha: torch.Tensor
    spatial_gamma: torch.Tensor
    spatial_weight: torch.Tensor

    @classmethod
    def make(cls, line_vuln_weight: float, contract_vuln_weight: float,
             spatial_alpha: float, spatial_gamma: float,
             spatial_weight: float, device=None) -> "DynamicScalars":
        vals = torch.tensor([line_vuln_weight, contract_vuln_weight,
                             spatial_alpha, spatial_gamma, spatial_weight],
                            dtype=torch.float32, device=device)
        return cls(*vals.unbind())


def compute_losses(model, batch: Dict[str, torch.Tensor],
                   scalars: DynamicScalars,
                   generator: Optional[torch.Generator], *, use_gan: bool,
                   use_augmentation: bool, tables: SyntaxLossTables,
                   deterministic: bool, fused_lm_ce: bool = False):
    """Forward + full loss mix. Returns (total_loss, (metrics, line_logits,
    line_labels, row_mask)).

    Puts the model in training mode (dropout on, seeds from ``generator``)
    unless ``deterministic``. ``batch['row_valid']`` (B,), when present,
    marks static-padding rows with 0: they are left out of every loss mean
    and metric. ``fused_lm_ce`` takes the generation CE through
    ``ops.fused_ce`` (no (B, S, V) logits kept between model and loss)."""
    target_ids = (batch["target_ids"] if use_augmentation
                  and "target_ids" in batch else batch["input_ids"])
    row_mask = batch.get("row_valid")
    mesh = model.mesh
    dp = SINGLE if mesh is None else mesh.axis("dp")
    model.train(not deterministic)
    outputs = model(
        input_ids=batch["input_ids"],
        attention_mask=batch["attention_mask"],
        ast_input_ids=batch["ast_input_ids"],
        ast_attention_mask=batch["ast_attention_mask"],
        target_ids=target_ids,
        token_to_line=batch["token_to_line"],
        return_lm_hidden=fused_lm_ce,
        generator=None if deterministic else generator)

    # the global batch's per-row outputs and labels on every rank (the
    # gathers are identities on one rank)
    local_rows = row_mask
    outputs = dict(outputs, **{
        k: gather_rows(outputs[k], dp) for k in (
            "contract_vulnerability_logits",
            "line_vulnerability_logits", "discriminator_logits")
        if outputs[k] is not None})
    batch = dict(batch, **{k: all_gather(batch[k], dp) for k in (
        "contract_vulnerabilities", "vulnerable_lines", "token_to_line",
        "row_valid") if k in batch})
    row_mask = batch.get("row_valid")

    # this rank's share of the global mean CE (its rows only: no (B, S, V)
    # logits cross dp), its value all-reduced, its gradient kept local
    if fused_lm_ce:
        head = model.output_layer
        ce_local = fused_linear_cross_entropy(
            outputs["lm_hidden"], head.weight, head.bias,
            outputs["target_ids"], local_rows,
            int(model.config.vocab_size), model.lm_axis, dp)
    else:
        ce_local = cross_entropy_loss(outputs["logits"], outputs["target_ids"],
                                      row_mask=local_rows, row_axis=dp)
    ce_all = all_reduce_(ce_local.detach().clone(), dp)
    ce = ce_local + (ce_all - ce_local.detach())
    targets = all_gather(outputs["target_ids"], dp)
    syntax_pen = syntax_penalty(targets, tables, row_mask=row_mask)
    gen_loss = ce + 0.5 * syntax_pen     # syntax_weight (train.py:314)

    contract_loss = contract_level_focal_loss(
        outputs["contract_vulnerability_logits"],
        batch["contract_vulnerabilities"].float(), alpha=0.05, gamma=4.0,
        row_mask=row_mask)

    # labels come in (B, 8, L); logits are (B, L, 8) (train.py:981-991)
    line_labels = batch["vulnerable_lines"].transpose(1, 2).float()
    line_logits = outputs["line_vulnerability_logits"]
    line_loss = spatial_aware_focal_loss(
        line_logits, line_labels, batch["token_to_line"],
        alpha=scalars.spatial_alpha, gamma=scalars.spatial_gamma,
        spatial_weight=scalars.spatial_weight, row_mask=row_mask)

    # loss floors (train.py:1184-1186) and high-loss scaling (1189-1194)
    contract_loss = torch.clamp_min(contract_loss, 1e-4)
    line_loss = torch.clamp_min(line_loss, 1e-6)
    line_loss = torch.where(line_loss > 5.0, line_loss * 0.1,
                            torch.where(line_loss > 1.0, line_loss * 0.5,
                                        line_loss))

    device = line_logits.device
    zero = torch.zeros((), device=device)
    disc_loss, adv_loss = zero, zero
    disc_conf = torch.full((), 0.5, device=device)
    if use_gan:
        disc_logits = outputs["discriminator_logits"]
        disc_loss = masked_mean(binary_cross_entropy_with_logits(
            disc_logits, torch.ones_like(disc_logits)), row_mask)
        sig = torch.sigmoid(disc_logits)
        disc_conf = masked_mean(sig, row_mask)
        conf_pen = torch.where(disc_conf > 0.8,
                               1.0 * masked_mean(sig ** 2, row_mask)
                               + 2.0 * masked_mean(sig ** 4, row_mask), zero)
        disc_loss = disc_loss + conf_pen
        adv_loss = torch.where(
            disc_conf < 0.3,
            masked_mean(binary_cross_entropy_with_logits(
                disc_logits, torch.zeros_like(disc_logits)), row_mask), zero)

    w_c = scalars.contract_vuln_weight
    w_l = scalars.line_vuln_weight
    if use_augmentation and use_gan:
        total = (0.5 * gen_loss + 0.25 * contract_loss * w_c
                 + 0.2 * line_loss * w_l + 0.05 * disc_loss)
        total = total + 0.02 * adv_loss
    elif use_augmentation:
        total = (0.6 * gen_loss + 0.25 * contract_loss * w_c
                 + 0.15 * line_loss * w_l)
    else:
        total = (0.5 * gen_loss + 0.3 * contract_loss * w_c
                 + 0.2 * line_loss * w_l)
        if use_gan:
            total = total + 0.05 * disc_loss + 0.02 * adv_loss

    if row_mask is None:
        # population std, as jnp.std (torch's default divides by n - 1)
        ll_mean, ll_std = line_logits.mean(), line_logits.std(correction=0)
    else:
        ll_mean = masked_mean(line_logits, row_mask)
        ll_std = torch.sqrt(torch.clamp_min(
            masked_mean((line_logits - ll_mean) ** 2, row_mask), 0.0))
    metrics = {
        "gen_loss": gen_loss,
        "ce_loss": ce,
        "syntax_loss": syntax_pen,
        "contract_vuln_loss": contract_loss,
        "line_vuln_loss": line_loss,
        "discriminator_loss": disc_loss,
        "discriminator_confidence": disc_conf,
        "total_loss": total,
        "line_logits_mean": ll_mean,
        "line_logits_std": ll_std,
    }
    return total, (metrics, line_logits, line_labels, row_mask)


@torch.no_grad()
def _line_batch_metrics(line_logits, line_labels, row_mask=None):
    """Adaptive-threshold batch metrics (train.py:1047-1155): a quantile
    threshold with conservative/ultra fallbacks, then precision, recall and
    accuracy against the line labels, all on the device. ``row_mask`` (B,)
    leaves static-padding rows out of the quantiles, counts and means."""
    probs = torch.sigmoid(line_logits)
    if row_mask is not None:
        valid = row_mask.bool().reshape(-1, 1, 1).expand(probs.shape)
        # invalid entries sort to the top; quantile positions index only the
        # first n (valid) entries, so pads never influence thresholds
        sorted_p = torch.sort(torch.where(valid, probs, float("inf"))
                              .reshape(-1)).values
        n = row_mask.float().sum() * probs.shape[1] * probs.shape[2]

        def _q(quant):
            pos = quant * (n - 1.0)
            lo = torch.floor(pos).long()
            w = pos - torch.floor(pos)
            hi = torch.minimum(lo + 1, (n - 1.0).long())
            return sorted_p[lo] * (1.0 - w) + sorted_p[hi] * w
    else:
        valid = None
        # one sort serves all three quantiles, with linear interpolation
        sorted_p = torch.sort(probs.reshape(-1)).values
        n = sorted_p.shape[0]

        def _q(quant):
            pos = quant * (n - 1)
            lo = int(pos // 1)
            w = torch.tensor(pos - lo, dtype=torch.float32)
            return sorted_p[lo] * (1.0 - w) + sorted_p[min(lo + 1, n - 1)] * w

    mask_or = lambda p: p if valid is None else p & valid
    q99 = _q(0.99)
    neg_regime = masked_mean(line_logits, row_mask) < -1.0
    thr = torch.where(neg_regime, torch.clamp(q99, 0.1, 0.4),
                      torch.clamp(q99, 0.3, 0.6))
    preds = mask_or(probs > thr)
    n_pred = preds.sum()

    # too-many-prediction fallbacks (train.py:1069-1086)
    cons_thr = torch.clamp_max(_q(0.995), 0.8)
    preds = torch.where(n_pred > 10000, mask_or(probs > cons_thr), preds)
    n_pred = preds.sum()
    ultra_thr = torch.clamp_max(_q(0.999), 0.9)
    preds = torch.where(n_pred > 5000, mask_or(probs > ultra_thr), preds)
    n_pred = preds.sum()

    # no-prediction fallbacks (train.py:1088-1105)
    pmax = (probs if valid is None else torch.where(valid, probs, 0.0)).max()
    fb_thr = torch.clamp_max(pmax * 0.5, 0.3)
    preds = torch.where((n_pred == 0) & (pmax > 0.1),
                        mask_or(probs > fb_thr), preds)
    n_pred = preds.sum()
    ufb_thr = torch.clamp_min(pmax * 0.3, 0.01)
    preds = torch.where(n_pred == 0, mask_or(probs > ufb_thr), preds)

    predf = preds.float()
    labelsf = (line_labels if valid is None
               else torch.where(valid, line_labels, 0.0))
    tp = (predf * labelsf).sum()
    total_vuln = labelsf.sum()
    total_pred = predf.sum()
    zero = torch.zeros((), device=probs.device)
    recall = torch.where(total_vuln > 0,
                         tp / torch.clamp_min(total_vuln, 1.0), zero)
    precision = torch.where(total_pred > 0,
                            tp / torch.clamp_min(total_pred, 1.0), zero)
    accuracy = masked_mean((predf == line_labels).float(), row_mask)
    return {
        "line_vuln_accuracy": accuracy,
        "line_vuln_precision": precision,
        "line_vuln_recall": recall,
        "line_predictions": total_pred,
        "line_threshold": thr,
        "batch_line_vulns": total_vuln,
    }


def make_train_step(model, fused_opt: FusedOptimizer,
                    tables: SyntaxLossTables, *, use_gan: bool,
                    use_augmentation: bool, fused_lm_ce: bool = False):
    """Build the train step. ``fused_opt`` is a ``FusedOptimizer`` or, for
    the unfused chain, a ``GradientTransform`` (the same interface).

    step(state, batch, scalars, lrs, generator) -> (state, metrics,
    next_scalars). ``state.params`` and ``state.opt_state`` are updated in
    place. ``next_scalars`` carries the reference's per-batch focal retune
    (train.py:1172-1182): the spatial focal α/γ/weight of the *next* batch
    depend on whether this batch had line vulnerabilities.
    """
    params = list(fused_opt.params)
    dp = SINGLE if model.mesh is None else model.mesh.axis("dp")

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             scalars: DynamicScalars, lrs: GroupLRs,
             generator: torch.Generator):
        total, (metrics, line_logits, line_labels, row_mask) = compute_losses(
            model, batch, scalars, generator, use_gan=use_gan,
            use_augmentation=use_augmentation, tables=tables,
            deterministic=False, fused_lm_ce=fused_lm_ce)
        grads = torch.autograd.grad(total, params, allow_unused=True)
        # a parameter the loss does not reach has a zero gradient, as in JAX
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, params)]
        # the ranks' shares summed into the global gradient (skipped on one
        # rank, where the flat copy would be a pass over every gradient)
        if dp.size > 1:
            flat = all_reduce_(torch.cat([g.reshape(-1).float()
                                          for g in grads]), dp)
            grads = [f.view_as(g) for f, g in zip(
                flat.split([g.numel() for g in grads]), grads)]
        metrics.update(_line_batch_metrics(line_logits.detach(),
                                           line_labels, row_mask))
        # clip norms, Adam, wd, group LRs and the NaN/explosion skip in one
        # pass over the parameters (optimizer.FusedOptimizer)
        gnorm, ok = fused_opt.update(grads, state.opt_state, lrs,
                                     total.detach())
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = gnorm
        metrics["skipped"] = (~ok).float()

        # per-batch focal retune for the next batch (train.py:1172-1182)
        has = metrics["batch_line_vulns"] > 0
        next_scalars = scalars._replace(
            spatial_alpha=torch.where(has, 0.1, 0.05),
            spatial_gamma=torch.where(has, 1.5, 1.0),
            spatial_weight=torch.where(has, 0.1, 0.05))
        return (TrainState(state.params, state.opt_state, state.step + 1),
                metrics, next_scalars)

    return step


def make_eval_step(model, tables: SyntaxLossTables, *, use_gan: bool,
                   use_augmentation: bool, fused_lm_ce: bool = False):
    """Validation step: eval-mode forward + the reference's val loss mix
    (train.py:1455-1470; no discriminator term in validation)."""

    @torch.no_grad()
    def step(batch, scalars: DynamicScalars):
        _, (metrics, _, _, _) = compute_losses(
            model, batch, scalars, None, use_gan=use_gan,
            use_augmentation=use_augmentation, tables=tables,
            deterministic=True, fused_lm_ce=fused_lm_ce)
        w_c = scalars.contract_vuln_weight
        w_l = scalars.line_vuln_weight
        if use_augmentation:
            val_total = (0.6 * metrics["gen_loss"]
                         + 0.25 * metrics["contract_vuln_loss"] * w_c
                         + 0.15 * metrics["line_vuln_loss"] * w_l)
        else:
            val_total = (0.5 * metrics["gen_loss"]
                         + 0.3 * metrics["contract_vuln_loss"] * w_c
                         + 0.2 * metrics["line_vuln_loss"] * w_l)
        metrics["total_loss"] = val_total
        return metrics

    return step
