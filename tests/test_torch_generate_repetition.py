"""The sampler's keywords (``max_length``, ``apply_syntax_constraints``,
``repetition_penalty``, ``track_repetition``) against the JAX package's
sampler and against their semantics, on the CPU.

The JAX and torch generators give different numbers from one seed, so the
comparisons with JAX are greedy (top-k 1) and the random paths are checked
by what they must do: a stub decoder that always prefers one token shows
the repetition tracker's noise and its stop.
"""
import jax
import numpy as np
import pytest
import torch

from sct_gan_tpu.infer.generate import make_generate_fn as jax_generate_fn
from sct_gan_tpu.losses.syntax import SyntaxLossTables
from sct_gan_tpu.models.sct_transformer import \
    SmartContractTransformer as JaxModel
from sct_gan_tpu_torch import SmartContractTransformer, convert_flax_params
from sct_gan_tpu_torch.data.tokenizer import SolidityTokenizer
from sct_gan_tpu_torch.infer.generate import (BOS_ID, EOS_ID, PAD_ID,
                                              make_generate_fn, syntax_boost,
                                              syntax_boost_ids)
from sct_gan_tpu_torch.ops.sampling import sample_top_k_top_p
from test_torch_model import CFG, _batch, _t, flax_params


@pytest.fixture(scope="module")
def setup():
    params = flax_params(CFG, seed=2)
    port = SmartContractTransformer(CFG, seed=None)
    port.load_state_dict(convert_flax_params(params, CFG))
    port.eval()
    b = _batch(seed=4)
    with torch.no_grad():
        memory = port.encode(*(_t(b)[k] for k in (
            "input_ids", "attention_mask", "ast_input_ids",
            "ast_attention_mask")))
    tok = SolidityTokenizer(vocab_size=CFG.vocab_size)
    return JaxModel(CFG), params, port, b, memory, tok


def _plain_sampler(model, syntax_ids, memory, src_mask, generator,
                   temperature, top_k=50, top_p=0.95, min_length=50):
    """The sampler as it was before the keywords: temperature, semicolon
    boost, top-k/top-p draw, EOS/PAD stop after min_length."""
    b = memory.shape[0]
    cross, caches = (model.precompute_cross_kv(memory),
                     model.init_decode_cache(b))
    tokens = torch.full((b, model.config.max_length), PAD_ID,
                        dtype=torch.long)
    tokens[:, 0] = BOS_ID
    finished = torch.zeros(b, dtype=torch.bool)
    for pos in range(model.config.max_length - 1):
        cur = tokens[:, pos:pos + 1]
        logits = syntax_boost(model.decode_step(cur, pos, caches, cross,
                                                src_mask) / temperature,
                              cur[:, 0], syntax_ids)
        nxt = torch.where(finished, PAD_ID,
                          sample_top_k_top_p(logits, top_k, top_p, generator))
        tokens[:, pos + 1] = nxt
        finished |= ((nxt == EOS_ID) | (nxt == PAD_ID)) & (pos > min_length)
        if bool(finished.all()):
            break
    return tokens


def test_keywords_off_keep_the_tokens(setup):
    """With every new keyword at its default the sampler draws what it
    drew before them, from the same generator."""
    _, _, port, b, memory, tok = setup
    ids = syntax_boost_ids(tok)
    src = _t(b)["attention_mask"].bool()
    with torch.no_grad():
        want = _plain_sampler(port, ids, memory, src,
                              torch.Generator().manual_seed(11), 0.8,
                              min_length=10)
    got, _ = make_generate_fn(port, ids, min_length=10)(
        memory, src, torch.Generator().manual_seed(11), 0.8)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_greedy_short_unconstrained_matches_jax(setup):
    """top-k 1, no syntax boost, max_length 20 < L: JAX's tokens."""
    jm, params, port, b, memory, tok = setup
    tables = SyntaxLossTables.from_tokenizer(tok)
    kw = dict(top_k=1, min_length=5, apply_syntax_constraints=False,
              max_length=20)
    got, steps = make_generate_fn(port, syntax_boost_ids(tok), **kw)(
        memory, _t(b)["attention_mask"].bool(), None, 0.8)
    jmem = jm.apply({"params": params}, b["input_ids"], b["attention_mask"],
                    b["ast_input_ids"], b["ast_attention_mask"],
                    method=jm.encode)
    want = jax_generate_fn(jm, tables, **kw)(
        params, jmem, b["attention_mask"].astype(bool),
        jax.random.PRNGKey(0), 0.8)
    assert got.shape == (2, 20) and 1 <= steps <= 19
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_repetition_penalty_changes_a_near_greedy_stream(setup):
    """As ``tests/test_infer.py`` shows for JAX: near-greedy sampling from
    a zero memory argmax-repeats; a strong penalty on the previous token
    knocks it off the argmax and changes the stream."""
    _, _, port, _, _, _ = setup
    kw = dict(min_length=4, max_length=32, top_k=0, top_p=1.0,
              apply_syntax_constraints=False)
    memory = torch.zeros(1, CFG.max_length, CFG.d_model)
    src = torch.ones(1, CFG.max_length, dtype=torch.bool)
    base, _ = make_generate_fn(port, **kw)(
        memory, src, torch.Generator().manual_seed(7), 1e-4)
    pen, _ = make_generate_fn(port, repetition_penalty=10.0, **kw)(
        memory, src, torch.Generator().manual_seed(7), 1e-4)
    assert not torch.equal(base, pen)


class _RepeatModel:
    """A decoder that always prefers token 7 (probability ~1 after the
    top-k filter), ignoring its inputs."""

    def __init__(self, vocab=64, max_length=32):
        self.config = type("Cfg", (), {"max_length": max_length})()
        self.logits = torch.zeros(vocab)
        self.logits[7] = 50.0

    def precompute_cross_kv(self, memory):
        return []

    def init_decode_cache(self, b, device=None):
        return []

    def decode_step(self, tokens, pos, caches, cross, src_mask):
        return self.logits.expand(tokens.shape[0], -1).clone()


def _run(model, rows, **kw):
    fn = make_generate_fn(model, None, top_k=2, top_p=1.0, min_length=100,
                          **kw)
    return fn(torch.zeros(rows, 4, 8), torch.ones(rows, 4, dtype=torch.bool),
              torch.Generator().manual_seed(3), 1.0)


def test_track_repetition_stops_a_repeating_row_after_break_after():
    """Noise held off: each row repeats 7 and stops once it has repeated
    more than ``break_after`` = 8 times, i.e. after 10 steps."""
    tokens, steps = _run(_RepeatModel(), 2, track_repetition=True,
                         noise_after=100, break_after=8)
    assert steps == 10
    assert tokens[:, 1:11].eq(7).all() and tokens[:, 11:].eq(PAD_ID).all()
    # without the tracker the rows never stop (no EOS, min_length 100)
    tokens, steps = _run(_RepeatModel(), 2)
    assert steps == 31 and tokens[:, 1:].eq(7).all()


def test_track_repetition_adds_noise_after_noise_after():
    """Up to ``noise_after`` = 3 repeats the draw is the filtered
    distribution (7, certainly); past it, U(0, 0.2) noise over the whole
    vocabulary is added and renormalised, which puts most of the mass off
    7: across 16 rows the streams leave 7 after position 5."""
    tokens, _ = _run(_RepeatModel(), 16, track_repetition=True,
                     noise_after=3, break_after=100)
    assert tokens[:, 1:6].eq(7).all()
    assert not tokens[:, 6:].eq(7).all()
