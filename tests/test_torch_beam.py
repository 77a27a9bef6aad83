"""The port's beam search and ``encode_concat`` against the JAX package's,
same weights, on the CPU.

Tiny configuration of ``test_torch_model.py`` (f32, so the CPU runs the
kernels' plain versions), weights through ``convert_flax_params``. Beam
tokens must be equal exactly (the argmax path of the search); the memory is
held to the model tests' 1e-4 and the attention plain versions to 1e-5
(``test_torch_ops.py``'s bar: the same math summed in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sct_gan_tpu.infer.generate import \
    make_beam_search_fn as jax_beam_search_fn
from sct_gan_tpu.models.sct_transformer import \
    SmartContractTransformer as JaxModel
from sct_gan_tpu.ops.attention import mha_reference as jax_mha_reference
from sct_gan_tpu_torch import SmartContractTransformer, convert_flax_params
from sct_gan_tpu_torch.infer.generate import (EOS_ID, PAD_ID, _top_k,
                                              beam_search,
                                              make_beam_search_fn)
from sct_gan_tpu_torch.ops.decode_attention import decode_attention
from sct_gan_tpu_torch.ops.flash_attention import flash_attention
from test_torch_model import CFG, TOL, _batch, _t, flax_params

BEAM, MAX_LEN = 3, 10


@pytest.fixture(scope="module")
def models():
    params = flax_params(CFG, seed=1)
    port = SmartContractTransformer(CFG, seed=None)
    port.load_state_dict(convert_flax_params(params, CFG))
    return JaxModel(CFG), params, port.eval()


def _concat_batch(seed):
    """``_batch`` with a contract half padded early in one row, so that the
    concatenated mask has a hole in the middle."""
    b = _batch(seed=seed)
    b["attention_mask"][1, 10:] = 0
    b["input_ids"][1, 10:] = 0
    return b


def _args(b):
    return (b["input_ids"], b["attention_mask"], b["ast_input_ids"],
            b["ast_attention_mask"])


def test_encode_concat_matches_jax(models):
    jm, params, port = models
    b = _concat_batch(0)
    want_mem, want_mask = jm.apply({"params": params}, *_args(b),
                                   method=jm.encode_concat)
    with torch.no_grad():
        mem, mask = port.encode_concat(*_args(_t(b)))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    # the hole: row 1 attends the contract's first 10 tokens, then the AST
    half = CFG.max_length // 2
    assert not mask[1, 10:half].any() and mask[1, half]
    np.testing.assert_allclose(mem.numpy(), np.asarray(want_mem), **TOL)


@pytest.mark.parametrize("seed", [0, 3])
def test_beam_tokens_equal_jax(models, seed):
    """B=2, K=3, max_length 10: JAX's fori_loop beam and the port's
    early-exiting loop give the same tokens."""
    jm, params, port = models
    b = _concat_batch(seed)
    want = jax_beam_search_fn(jm, beam_size=BEAM, max_length=MAX_LEN)(
        params, *_args(b), 1.0)
    out = make_beam_search_fn(port, beam_size=BEAM, max_length=MAX_LEN)(
        *_args(_t(b)), 1.0)
    np.testing.assert_array_equal(out["generated_sequence"].numpy(),
                                  np.asarray(want["generated_sequence"]))
    np.testing.assert_allclose(out["encoder_output"].numpy(),
                               np.asarray(want["encoder_output"]), **TOL)


def _oracle(step_logp, b, kk, max_len):
    """The per-hypothesis beam of ``tests/test_infer.py``: expand every
    live hypothesis by its top-k tokens (ties to the lower id), a frozen
    one by PAD at log-prob 0, keep the k best (a stable sort: ties keep
    parent-major, candidate-minor order, ``jax.lax.top_k``'s)."""
    want = []
    for row in range(b):
        beams = [([1], 0.0, False)]            # (tokens, score, finished)
        for _ in range(max_len - 1):
            cands = []
            for tokens, score, fin in beams:
                if fin:
                    cands.append((tokens + [PAD_ID], score, True))
                    continue
                lp = step_logp(tokens, row)
                for t in np.argsort(-lp, kind="stable")[:kk]:
                    cands.append((tokens + [int(t)], score + float(lp[t]),
                                  t == EOS_ID))
            cands.sort(key=lambda x: -x[1])
            beams = cands[:kk]
        want.append(beams[0][0])
    return np.array([w + [PAD_ID] * (max_len - len(w)) for w in want])


def test_beam_matches_numpy_oracle(models):
    """The batched search against the oracle, which re-decodes each
    hypothesis's full prefix through the port's ``decode_step`` with fresh
    caches: a fault in the cache reindex diverges the two."""
    _, _, port = models
    b = _t(_concat_batch(7))
    got = make_beam_search_fn(port, beam_size=BEAM, max_length=MAX_LEN)(
        *_args(b))["generated_sequence"].numpy()
    with torch.no_grad():
        memory, src_mask = port.encode_concat(*_args(b))

        def step_logp(prefix, row):
            caches = port.init_decode_cache(1)
            cross = port.precompute_cross_kv(memory[row:row + 1])
            for pos, t in enumerate(prefix):
                lg = port.decode_step(torch.tensor([[t]]), pos, caches,
                                      cross, src_mask[row:row + 1])
            return torch.log_softmax(lg[0], -1).numpy()

        want = _oracle(step_logp, 2, BEAM, MAX_LEN)
    np.testing.assert_array_equal(got, want)


def test_hole_mask_through_the_attention_plain_versions():
    """``encode_concat``'s mask (a hole in the middle of a row) through
    ``flash_attention``'s and ``decode_attention``'s plain versions against
    JAX's ``mha_reference``."""
    rng = np.random.default_rng(5)
    b, h, s, d = 2, 2, 48, 32
    q, k, v = (rng.normal(size=(b, h, s, d)).astype(np.float32)
               for _ in range(3))
    pos = np.arange(s // 2)[None, :]
    mask = np.concatenate([pos < np.array([[24], [5]]),
                           pos < np.array([[10], [24]])], axis=1)
    want = np.asarray(jax_mha_reference(*map(jnp.asarray, (q, k, v)),
                                        key_padding_mask=jnp.asarray(mask)))
    got = flash_attention(*map(torch.from_numpy, (q, k, v)),
                          key_padding_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    got = decode_attention(*(torch.from_numpy(x) for x in (q[:, :, :1], k, v)),
                           torch.from_numpy(mask), sm_scale=d ** -0.5)
    np.testing.assert_allclose(got.numpy(), want[:, :, :1], rtol=1e-5,
                               atol=1e-5)


def test_top_k_breaks_ties_to_the_lower_index():
    """A row of frozen beams is all ties (-1e30 plus a score is -1e30 in
    f32): the port's top-k orders ties as ``jax.lax.top_k`` does."""
    rows = np.array([[-1e30, 0.0, -1e30, -1e30, -1e30],
                     [-1e30] * 5,
                     [0.5, 0.25, 0.5, 0.25, 0.5],
                     [-3.0, -1e30 + -3.0, -1e30, 2.0, 2.0]], np.float32)
    vals, idx = _top_k(torch.from_numpy(rows), 3)
    want_vals, want_idx = jax.lax.top_k(jnp.asarray(rows), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_vals))


class _TieModel:
    """A decoder whose step log-probs are fixed: EOS first, then two tokens
    with equal logits, then the rest; so step 1 freezes beam 0 and every
    later expansion is full of ties."""

    def __init__(self, vocab=16):
        self.config = CFG
        logits = torch.full((vocab,), -4.0)
        logits[EOS_ID], logits[5], logits[6] = 2.0, 1.0, 1.0
        self.logits = logits

    def encode_concat(self, ids, mask, ast_ids, ast_mask):
        b = ids.shape[0]
        return torch.zeros(b, 4, 8), torch.ones(b, 4, dtype=torch.bool)

    def precompute_cross_kv(self, memory):
        return []

    def init_decode_cache(self, b, device=None):
        return []

    def decode_step(self, tokens, pos, caches, cross, src_mask):
        return self.logits.expand(tokens.shape[0], -1).clone()


def test_frozen_beams_follow_the_index_tie_break():
    """Beam 0 freezes at step 1 and keeps the best score; the two tied
    continuations are ranked by index at every step, as the oracle (and
    ``jax.lax.top_k``) rank them; the search stops early once every beam
    is frozen and its tokens are the oracle's."""
    model = _TieModel()
    ids = torch.zeros(1, 4, dtype=torch.long)
    tokens, scores, _, steps = beam_search(model, ids, ids, ids, ids,
                                           beam_size=BEAM, max_length=8)
    logp = torch.log_softmax(model.logits, -1).numpy()
    want = _oracle(lambda prefix, row: logp, 1, BEAM, 8)
    np.testing.assert_array_equal(tokens[:, 0].numpy(), want)
    assert tokens[0, 0, :3].tolist() == [1, EOS_ID, PAD_ID]
    assert tokens[0, 1, :3].tolist() == [1, 5, EOS_ID]   # 5 before 6
    assert torch.all(scores[0, :-1] >= scores[0, 1:])
    assert steps < 7                      # every beam froze: early exit
