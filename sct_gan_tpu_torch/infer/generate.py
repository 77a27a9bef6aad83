"""KV-cached autoregressive generation and batched beam search.

Counterpart of ``sct_gan_tpu/infer/generate.py``.

``make_generate_fn`` is the sampler: the encoder runs once,
cross-attention K/V are projected once per layer, and each token runs
``decode_step`` against per-layer KV caches updated in place. Sampling, in
the JAX order: temperature → semicolon boost after return/break/continue →
optional repetition penalty → top-k 50 / top-p 0.95 → draw from an
explicit ``torch.Generator``. A row stops on EOS(2)/PAD(0) only after
``pos > min_length``; finished rows emit PAD. ``track_repetition`` adds the
reference's diagnostic repetition machinery (noise after ``noise_after``
repeats of a token, a stop after ``break_after``).

``make_beam_search_fn`` decodes B × beam_size hypotheses as one batch
through the same ``decode_step`` (so the decode kernel runs at B·K rows),
reindexing tokens, caches and finished flags by parent beam each step.

Both loops are eager Python: checking whether every row has finished is
one host sync per token, and the loop stops there.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from ..ops.sampling import (penalize_repetition, sample_top_k_top_p,
                            top_k_top_p_filter)

BOS_ID = 1
EOS_ID = 2
PAD_ID = 0
_NEG = -1e30    # a removed candidate's log-prob, as the JAX beam writes it

SyntaxIds = Tuple[int, int, int, int]   # ";", "return", "break", "continue"


def syntax_boost_ids(tokenizer) -> SyntaxIds:
    """Token ids of ``;``, ``return``, ``break`` and ``continue`` (-1 where
    the tokenizer maps the token to its unknown id), as
    ``SyntaxLossTables.from_tokenizer`` resolves them."""
    unk = getattr(tokenizer, "unk_token_id", None)

    def tid(tok: str) -> int:
        i = tokenizer.convert_tokens_to_ids(tok)
        return -1 if i is None or i == unk else int(i)

    return tid(";"), tid("return"), tid("break"), tid("continue")


def syntax_boost(logits: torch.Tensor, prev_token: torch.Tensor,
                 ids: Optional[SyntaxIds]) -> torch.Tensor:
    """Double the semicolon logit where the previous token is
    return/break/continue."""
    if ids is None or ids[0] < 0:
        return logits
    sem, ret, brk, cont = ids
    stmt = (prev_token == ret) | (prev_token == brk) | (prev_token == cont)
    out = logits.clone()
    out[:, sem] = torch.where(stmt, logits[:, sem] * 2.0, logits[:, sem])
    return out


def make_generate_fn(model, syntax_ids: Optional[SyntaxIds] = None, *,
                     top_k: int = 50, top_p: float = 0.95,
                     min_length: int = 50,
                     apply_syntax_constraints: bool = True,
                     max_length: Optional[int] = None,
                     repetition_penalty: float = 1.0,
                     track_repetition: bool = False,
                     noise_after: int = 3, break_after: int = 8) -> Callable:
    """Build ``fn(memory, src_mask, generator, temperature) -> (tokens,
    steps)``: (B, max_length) int64 ids starting with BOS, and the number
    of ``decode_step`` calls made.

    ``syntax_ids=None`` or ``apply_syntax_constraints=False`` turns the
    semicolon boost off. ``max_length`` (at most the config's, which it
    defaults to) bounds the sequence. ``repetition_penalty`` != 1 divides
    the previous token's positive logit by it (multiplies a negative one).
    ``track_repetition`` counts each row's consecutive repeats of a token:
    past ``noise_after`` the filtered distribution gets U(0, 0.2) noise
    from ``generator`` and is renormalised, past ``break_after`` the row
    stops. With every option at its default the tokens and the generator's
    draws are those of the plain sampler."""
    max_len = int(max_length or model.config.max_length)
    if max_len > model.config.max_length:
        raise ValueError(f"max_length {max_len} > the model's "
                         f"{model.config.max_length}")
    boost_ids = syntax_ids if apply_syntax_constraints else None

    def draw(logits, rep_count, generator):
        if not track_repetition:
            return sample_top_k_top_p(logits, top_k, top_p, generator)
        # the noise needs the dense filtered distribution
        probs = torch.softmax(top_k_top_p_filter(logits, top_k, top_p), -1)
        noise = torch.rand(probs.shape, generator=generator,
                           device=probs.device) * 0.2
        noisy = probs + noise
        noisy = noisy / noisy.sum(-1, keepdim=True)
        probs = torch.where((rep_count > noise_after)[:, None], noisy, probs)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    @torch.inference_mode()
    def generate(memory: torch.Tensor, src_mask: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 temperature: float = 0.7):
        b, dev = memory.shape[0], memory.device
        cross_kvs = model.precompute_cross_kv(memory)
        caches = model.init_decode_cache(b, dev)
        tokens = torch.full((b, max_len), PAD_ID, dtype=torch.long,
                            device=dev)
        tokens[:, 0] = BOS_ID
        finished = torch.zeros(b, dtype=torch.bool, device=dev)
        rep_count = torch.zeros(b, dtype=torch.long, device=dev)
        steps = 0
        for pos in range(max_len - 1):
            cur = tokens[:, pos:pos + 1]
            logits = model.decode_step(cur, pos, caches, cross_kvs, src_mask)
            logits = logits / temperature
            logits = syntax_boost(logits, cur[:, 0], boost_ids)
            if repetition_penalty != 1.0:
                logits = penalize_repetition(logits, cur[:, 0],
                                             repetition_penalty)
            nxt = torch.where(finished, PAD_ID,
                              draw(logits, rep_count, generator))
            tokens[:, pos + 1] = nxt
            stop = ((nxt == EOS_ID) | (nxt == PAD_ID)) & (pos > min_length)
            if track_repetition:
                rep_count = torch.where(nxt == cur[:, 0], rep_count + 1, 0)
                stop |= rep_count > break_after
            finished |= stop
            steps += 1
            if bool(finished.all()):
                break
        return tokens, steps

    return generate


def _top_k(x: torch.Tensor, k: int):
    """The k largest entries of each row, descending, ties to the lower
    index (``jax.lax.top_k``'s order; ``torch.topk`` promises none, and a
    row of frozen beams is all ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


@torch.inference_mode()
def beam_search(model, input_ids, attention_mask, ast_input_ids,
                ast_attention_mask, *, beam_size: int = 3,
                max_length: Optional[int] = None, temperature: float = 1.0):
    """Batched beam search over ``encode_concat``'s memory.

    Returns (tokens (B, K, L) int64, scores (B, K) f32, memory, steps): the
    hypotheses sorted best first, their summed log-probabilities, the
    encoder output and the ``decode_step`` calls made. The JAX loop runs
    all L - 1 steps; this one stops once every hypothesis has emitted EOS,
    since a frozen hypothesis then only appends PAD at log-prob 0, which
    changes neither its tokens nor the order.
    """
    kk = beam_size
    max_len = int(max_length or model.config.max_length)
    if max_len > model.config.max_length:
        raise ValueError(f"max_length {max_len} > the model's "
                         f"{model.config.max_length}")
    memory, src_mask = model.encode_concat(input_ids, attention_mask,
                                           ast_input_ids, ast_attention_mask)
    b, dev = memory.shape[0], memory.device
    memory_k = memory.repeat_interleave(kk, dim=0)
    src_mask_k = src_mask.repeat_interleave(kk, dim=0)
    cross_kvs = model.precompute_cross_kv(memory_k)
    caches = model.init_decode_cache(b * kk, dev)
    tokens = torch.full((b * kk, max_len), PAD_ID, dtype=torch.long,
                        device=dev)
    tokens[:, 0] = BOS_ID
    # beam 0 live, the others at -1e30 so step 1 expands distinct candidates
    scores = torch.full((b, kk), _NEG, device=dev)
    scores[:, 0] = 0.0
    finished = torch.zeros(b, kk, dtype=torch.bool, device=dev)
    row0 = torch.arange(b, device=dev)[:, None] * kk
    steps = 0
    for pos in range(max_len - 1):
        logits = model.decode_step(tokens[:, pos:pos + 1], pos, caches,
                                   cross_kvs, src_mask_k)
        logp = torch.log_softmax(logits.float() / temperature, dim=-1)
        # frozen (EOS) hypotheses continue only with PAD, at log-prob 0
        pad_only = torch.full_like(logp, _NEG)
        pad_only[:, PAD_ID] = 0.0
        logp = torch.where(finished.reshape(-1, 1), pad_only, logp)
        cand_lp, cand_tok = _top_k(logp, kk)                    # (B*K, K)
        total = (scores.reshape(-1, 1) + cand_lp).reshape(b, kk * kk)
        scores, flat = _top_k(total, kk)                        # (B, K)
        parent = flat // kk
        rows = (row0 + parent).reshape(-1)          # hypothesis rows kept
        new_tok = cand_tok.reshape(b, kk * kk).gather(1, flat)  # (B, K)
        # reindex by parent: tokens, the live rows [:pos + 1] of every
        # cache (written in place at pos by this step), the flags
        tokens = tokens.index_select(0, rows)
        tokens[:, pos + 1] = new_tok.reshape(-1)
        for kc, vc in caches:
            kc[:, :, :pos + 1] = kc[:, :, :pos + 1].index_select(0, rows)
            vc[:, :, :pos + 1] = vc[:, :, :pos + 1].index_select(0, rows)
        finished = finished.reshape(-1)[rows].reshape(b, kk) | (
            new_tok == EOS_ID)
        steps += 1
        if bool(finished.all()):
            break
    return tokens.reshape(b, kk, max_len), scores, memory, steps


def make_beam_search_fn(model, *, beam_size: int = 3,
                        max_length: Optional[int] = None) -> Callable:
    """Build ``fn(input_ids, attention_mask, ast_input_ids,
    ast_attention_mask, temperature=1.0) -> {"generated_sequence": (B, L),
    "encoder_output": (B, d) f32}``: the best hypothesis of each row and the
    mean of ``encode_concat``'s memory, as the JAX function returns them.
    After a call, ``fn.last_steps`` holds its decode steps,
    ``fn.last_tokens`` and ``fn.last_scores`` the (B, K, L) hypotheses,
    best first, and their (B, K) summed log-probabilities."""

    def run(input_ids, attention_mask, ast_input_ids, ast_attention_mask,
            temperature: float = 1.0) -> Dict[str, torch.Tensor]:
        tokens, scores, memory, steps = beam_search(
            model, input_ids, attention_mask, ast_input_ids,
            ast_attention_mask, beam_size=beam_size, max_length=max_length,
            temperature=temperature)
        run.last_steps, run.last_tokens, run.last_scores = (steps, tokens,
                                                            scores)
        return {"generated_sequence": tokens[:, 0],
                "encoder_output": memory.mean(dim=1).float()}

    run.last_steps, run.last_tokens, run.last_scores = 0, None, None
    return run
