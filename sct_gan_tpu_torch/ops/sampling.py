"""Sampling ops: top-k / top-p filtering and categorical draws.

Counterpart of ``sct_gan_tpu/ops/sampling.py``. Draws take an explicit
``torch.Generator``; it gives other numbers than a JAX key of the same seed,
so the tests compare the sampler in distribution.
"""
from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -1e30


def _nucleus_remove(sorted_logits: torch.Tensor, p: float) -> torch.Tensor:
    """Removal mask over descending-sorted logits: cumulative probability
    > p, shifted right by one so the most likely token is always kept."""
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    remove = cum > p
    remove[..., 1:] = remove[..., :-1].clone()
    remove[..., 0] = False
    return remove


def top_k_filter(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the k largest logits of each row (and any tied with the k-th),
    set the rest to -1e30; k <= 0 or k >= the vocab keeps all."""
    if k <= 0 or k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits >= kth, logits, _NEG_INF)


def top_p_filter(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering over the full vocab (tokens removed → -1e30)."""
    if p >= 1.0:
        return logits
    sorted_logits, sorted_idx = torch.sort(logits, dim=-1, descending=True)
    remove = torch.zeros_like(logits, dtype=torch.bool).scatter(
        -1, sorted_idx, _nucleus_remove(sorted_logits, p))
    return logits.masked_fill(remove, _NEG_INF)


def _top_k_top_p_values(logits: torch.Tensor, top_k: int, top_p: float):
    """The k largest logits (descending) with nucleus-removed ones at -1e30,
    and their vocab indices."""
    vals, idx = torch.topk(logits, top_k, dim=-1)
    if top_p < 1.0:
        vals = vals.masked_fill(_nucleus_remove(vals, top_p), _NEG_INF)
    return vals, idx


def top_k_top_p_filter(logits: torch.Tensor, top_k: int = 50,
                       top_p: float = 0.95) -> torch.Tensor:
    """Top-k, then top-p over the k survivors (the reference's order);
    everything removed is set to -1e30."""
    if top_k <= 0 or top_k >= logits.shape[-1]:
        return top_p_filter(logits, top_p)
    vals, idx = _top_k_top_p_values(logits, top_k, top_p)
    return torch.full_like(logits, _NEG_INF).scatter(-1, idx, vals)


def sample_top_k_top_p(logits: torch.Tensor, top_k: int = 50,
                       top_p: float = 0.95,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    """One token per row of (B, V) logits from the top-k/top-p-filtered
    distribution: a categorical over the k kept logits, then an index
    gather — the full-vocab filtered logits are never formed. (B,) int64."""
    if top_k <= 0 or top_k >= logits.shape[-1]:
        vals, idx = top_p_filter(logits, top_p), None
    else:
        vals, idx = _top_k_top_p_values(logits, top_k, top_p)
    probs = torch.softmax(vals.float(), dim=-1)
    choice = torch.multinomial(probs, 1, generator=generator)    # (B, 1)
    if idx is None:
        return choice[:, 0]
    return torch.gather(idx, -1, choice)[:, 0]


def sample_categorical(logits: torch.Tensor, temperature: float = 1.0,
                       top_k: int = 0, top_p: float = 1.0,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    """One token per row of (..., V) logits: scaled by 1 / temperature,
    filtered by ``top_k_top_p_filter``, then drawn from the softmax. The
    JAX function takes its key first; here the ``torch.Generator`` comes
    last, as in ``sample_top_k_top_p``, and draws other numbers than a JAX
    key of the same seed. Returns int64 indices of shape (...)."""
    if temperature != 1.0:
        logits = logits / temperature
    logits = top_k_top_p_filter(logits, top_k, top_p)
    probs = torch.softmax(logits.float().reshape(-1, logits.shape[-1]), -1)
    choice = torch.multinomial(probs, 1, generator=generator)
    return choice.reshape(logits.shape[:-1])


def penalize_repetition(logits: torch.Tensor, prev_token: torch.Tensor,
                        penalty: float = 1.5) -> torch.Tensor:
    """Divide the previous token's positive logit by ``penalty`` (multiply a
    negative one) — the CTRL-style repetition penalty."""
    prev = prev_token.long()[:, None]
    picked = torch.gather(logits, -1, prev)
    picked = torch.where(picked > 0, picked / penalty, picked * penalty)
    return logits.scatter(-1, prev, picked)
