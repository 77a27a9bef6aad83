"""Syntax-aware generation loss of the port: ``sct_gan_tpu/losses/syntax.py``.

Parity with SoliditySyntaxLoss (SCT-GAN/train.py:247-431): cross-entropy
over vocab logits plus a syntax penalty scanned over the *target* token
stream — keyword-follower violations (+2.0), missing semicolons after
return/break/continue (+1.5), unbalanced parentheses within a 19-token
lookahead (+1.0) and braces within a 49-token lookahead (+1.0); the penalty
is the average over violations. The keyword/follower id tables are built
once on the host (``SyntaxLossTables``); the scan is vectorised comparisons
and two prefix-sum window checks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import torch

from ..parallel.collectives import SINGLE, Axis, all_reduce_

KEYWORD_FOLLOWERS: Dict[str, List[str]] = {
    "function": ["(", "view", "pure", "external", "public", "internal", "private"],
    "contract": ["{", "is", "interface"],
    "if": ["("],
    "for": ["("],
    "while": ["("],
    "require": ["("],
    "assert": ["("],
    "revert": ["("],
    "emit": ["("],
    "return": [";", "("],
    "break": [";"],
    "continue": [";"],
    "import": ['"', "'"],
    "pragma": ["solidity"],
    "struct": ["{"],
    "enum": ["{"],
    "event": ["("],
    "modifier": ["{", "("],
    "mapping": ["("],
}

_PAREN_WINDOW = 19   # range(i+1, min(i+20, S)) → 19 tokens (train.py:403)
_BRACE_WINDOW = 49   # range(i+1, min(i+50, S)) → 49 tokens (train.py:415)


@dataclass(frozen=True)
class SyntaxLossTables:
    """Host-precomputed token-id tables (train.py:260-312)."""

    keyword_ids: Tuple[int, ...]
    follower_ids: Tuple[Tuple[int, ...], ...]   # per keyword, same order
    semicolon_id: int
    open_paren_id: int
    close_paren_id: int
    open_brace_id: int
    close_brace_id: int
    return_id: int
    break_id: int
    continue_id: int

    @classmethod
    def from_tokenizer(cls, tokenizer) -> "SyntaxLossTables":
        unk = getattr(tokenizer, "unk_token_id", None)

        def tid(tok):
            i = tokenizer.convert_tokens_to_ids(tok)
            return -1 if i is None or i == unk else int(i)

        kws, fols = [], []
        for kw, followers in KEYWORD_FOLLOWERS.items():
            k = tid(kw)
            if k < 0:
                continue
            f = tuple(x for x in (tid(t) for t in followers) if x >= 0)
            if f:
                kws.append(k)
                fols.append(f)
        return cls(
            keyword_ids=tuple(kws), follower_ids=tuple(fols),
            semicolon_id=tid(";"), open_paren_id=tid("("),
            close_paren_id=tid(")"), open_brace_id=tid("{"),
            close_brace_id=tid("}"), return_id=tid("return"),
            break_id=tid("break"), continue_id=tid("continue"))


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       row_mask=None, row_axis: Axis = SINGLE
                       ) -> torch.Tensor:
    """Mean token cross-entropy over ALL positions (the reference does not
    ignore padding, train.py:324): logsumexp in f32 minus the picked
    logit. ``row_mask`` (B,) weighs batch rows. Under dp (``row_axis``)
    the rows are this rank's and the value is its share of the global
    mean: its summed NLL over the count summed over the axis."""
    lse = torch.logsumexp(logits.float(), dim=-1)
    picked = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = lse - picked.float()
    if row_mask is None:
        if row_axis.size == 1:
            return nll.mean()
        return nll.sum() / (nll.numel() * row_axis.size)
    m = row_mask.float()
    count = all_reduce_(m.sum(), row_axis)
    return (nll * m[:, None]).sum() / torch.clamp_min(count * nll.shape[1],
                                                      1.0)


def _window_has(token_match: torch.Tensor, window: int) -> torch.Tensor:
    """out[i] = any(token_match[i+1 : i+1+window]) via prefix sums, O(S)."""
    cs = torch.cumsum(token_match.long(), dim=-1)
    s = token_match.shape[-1]
    hi = torch.clamp_max(torch.arange(s, device=cs.device) + window, s - 1)
    return (cs[..., hi] - cs) > 0


def syntax_penalty(target_ids: torch.Tensor, tables: SyntaxLossTables,
                   row_mask=None) -> torch.Tensor:
    """Average violation penalty over the batch (train.py:334-427);
    ``row_mask`` (B,) excludes static-padding rows from totals and count."""
    t = target_ids.long()
    cur, nxt = t[:, :-1], t[:, 1:]
    w = (torch.ones(t.shape[0], 1, device=t.device) if row_mask is None
         else row_mask.float()[:, None])
    total = torch.zeros((), device=t.device)
    count = torch.zeros((), device=t.device)

    def add(viol, weight):
        nonlocal total, count
        n = (viol.float() * w).sum()
        total = total + weight * n
        count = count + n

    for k, followers in zip(tables.keyword_ids, tables.follower_ids):
        ok = torch.zeros_like(cur, dtype=torch.bool)
        for f in followers:
            ok = ok | (nxt == f)
        add((cur == k) & ~ok, 2.0)
    stmt = ((cur == tables.return_id) | (cur == tables.break_id)
            | (cur == tables.continue_id))
    add(stmt & (nxt != tables.semicolon_id), 1.5)
    # the reference scans positions 0..S-2 (train.py:379); keep that range
    close_p = _window_has(t == tables.close_paren_id, _PAREN_WINDOW)[:, :-1]
    add((cur == tables.open_paren_id) & ~close_p, 1.0)
    close_b = _window_has(t == tables.close_brace_id, _BRACE_WINDOW)[:, :-1]
    add((cur == tables.open_brace_id) & ~close_b, 1.0)
    return torch.where(count > 0, total / torch.clamp_min(count, 1.0), 0.0)


def solidity_syntax_loss(logits: torch.Tensor, target_ids: torch.Tensor,
                         tables: SyntaxLossTables, syntax_weight: float = 0.5,
                         row_mask=None):
    """CE + syntax_weight · penalty (train.py:314-332); returns
    (total, ce, penalty)."""
    ce = cross_entropy_loss(logits, target_ids, row_mask=row_mask)
    pen = syntax_penalty(target_ids, tables, row_mask=row_mask)
    return ce + syntax_weight * pen, ce, pen
