"""Generation-quality metrics: teacher-forced perplexity.

Counterpart of ``sct_gan_tpu/evals/perplexity.py``: exp(mean token
cross-entropy) of the LM head teacher-forced on held-out contracts, padding
masked (the standard definition) and unmasked (the reference's CE
convention), over the model's full forward.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

_INPUTS = ("input_ids", "attention_mask", "ast_input_ids",
           "ast_attention_mask", "token_to_line")


def _ce_sums(model, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """(masked nll sum, unpadded tokens, nll sum, tokens) of one batch, f32
    on the device: the nll is logsumexp of the logits less the target's."""
    out = model(**{k: batch[k] for k in _INPUTS},
                target_ids=batch["input_ids"])
    logits, targets = out["logits"], out["target_ids"]    # (B, S-1, V)
    lse = torch.logsumexp(logits.float(), dim=-1)
    picked = logits.gather(-1, targets[..., None])[..., 0].float()
    nll = lse - picked
    mask = (targets != 0).float()                         # ignore padding
    return torch.stack([(nll * mask).sum(), mask.sum(), nll.sum(),
                        torch.tensor(float(nll.numel()), device=nll.device)])


def compute_perplexity(model, dataloader,
                       max_batches: Optional[int] = None) -> Dict[str, float]:
    """Teacher-forced perplexity over a dataloader of numpy batches, the
    model in eval mode (its mode is restored after). Each batch's four sums
    come back to the host in one read. Returns the padding-masked
    cross-entropy and perplexity, their unmasked variants and the count of
    unpadded target tokens."""
    device = next(model.parameters()).device
    totals = np.zeros(4)
    was_training = model.training
    model.eval()
    try:
        with torch.inference_mode():
            for i, batch in enumerate(dataloader):
                if max_batches is not None and i >= max_batches:
                    break
                tb = {k: torch.from_numpy(np.asarray(batch[k], np.int64)).to(
                    device) for k in _INPUTS}
                totals += np.asarray(_ce_sums(model, tb).tolist())
    finally:
        model.train(was_training)
    s_m, n_m, s_a, n_a = totals
    ce_masked = s_m / max(n_m, 1.0)
    ce_all = s_a / max(n_a, 1.0)
    return {
        "cross_entropy": float(ce_masked),
        "perplexity": math.exp(min(ce_masked, 30.0)),
        "cross_entropy_unmasked": float(ce_all),
        "perplexity_unmasked": math.exp(min(ce_all, 30.0)),
        "tokens": float(n_m),
    }
