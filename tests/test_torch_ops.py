"""The port's ops against the JAX package's, on the CPU, same numpy inputs.

On the CPU a kernel wrapper runs its plain PyTorch version; the JAX side
runs its Pallas kernels in interpret mode, as ``tests/test_ops.py`` does.
Tolerance 1e-5 (rtol and atol) in f32: the same math summed in another
order. The kernels themselves run only on a CUDA card: their tests are in
``test_torch_kernels.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sct_gan_tpu.ops import sampling as jax_sampling
from sct_gan_tpu.ops.attention import mha_reference as jax_mha
from sct_gan_tpu.ops.decode_attention import \
    decode_attention as jax_decode_attention
from sct_gan_tpu.ops.flash_attention import _flash_forward as jax_flash_forward
from sct_gan_tpu.ops.flash_attention import \
    flash_attention as jax_flash_attention
from sct_gan_tpu.ops.segment_mean import line_segment_mean as jax_segmean
from sct_gan_tpu_torch.ops import sampling
from sct_gan_tpu_torch.ops.attention import dot_product_attention
from sct_gan_tpu_torch.ops.decode_attention import decode_attention
from sct_gan_tpu_torch.ops.flash_attention import flash_attention
from sct_gan_tpu_torch.ops.segment_mean import line_segment_mean
from test_torch_kernels import FLASH_CASES

TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(rng, b, h, sq, sk, d):
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((b, h, sq, d), (b, h, sk, d), (b, h, sk, d)))


def _as_layout(x: np.ndarray, layout: str) -> torch.Tensor:
    """(B, H, S, d) numpy array as a torch tensor in a FLASH_CASES layout:
    "heads" is the model's (B, H, S, d) view of a (B, S, H*d) tensor."""
    if layout != "heads":
        return torch.from_numpy(x)
    b, h, s, d = x.shape
    flat = torch.from_numpy(x).transpose(1, 2).reshape(b, s, h * d)
    return flat.view(b, s, h, d).transpose(1, 2)


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_plain_matches_jax_kernel_and_reference(case):
    """At the case's Sq, Sk, mask and layout (B=2, H=2, d=32 here)."""
    sq, sk, causal, kind, (_, _, layout) = FLASH_CASES[case]
    rng = np.random.default_rng(0)
    b, h, d = 2, 2, 32
    q, k, v = _qkv(rng, b, h, sq, sk, d)
    mask = None
    if kind is not None:
        mask = np.arange(sk)[None, :] < np.asarray([sk - 7, sk // 2])[:, None]
        if kind == "one_row_empty":
            mask[1] = False
    scale = 1.0 / 96 ** 0.5
    jmask = None if mask is None else jnp.asarray(mask)
    with pltpu.force_tpu_interpret_mode():
        want_k = jax_flash_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), key_padding_mask=jmask,
                                     causal=causal, sm_scale=scale)
    want_r = jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     key_padding_mask=jmask, causal=causal, sm_scale=scale)
    got = flash_attention(_as_layout(q, layout), _as_layout(k, layout),
                          _as_layout(v, layout),
                          key_padding_mask=(None if mask is None
                                            else torch.from_numpy(mask)),
                          causal=causal, sm_scale=scale).numpy()
    np.testing.assert_allclose(got, np.asarray(want_k), **TOL)
    np.testing.assert_allclose(got, np.asarray(want_r), **TOL)
    if kind == "one_row_empty":
        assert np.all(got[1] == 0.0)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_plain_matches_jax_kernel_over_skipped_tiles(causal):
    """The semantics K1's tile skip keeps: a row with whole masked 64-key
    tiles (0 and 2 dead, 3 partly live), a row that attends no key, and a
    masked tail under the causal diagonal (B=3, H=2, S=256, d=32). The
    plain version against the JAX forward in interpret mode with 64-key
    blocks, so that its online softmax too steps across the dead tiles
    and the empty row a tile at a time; output and LSE. The empty row
    gives exact zeros and lse = -1e30 (JAX's finite mask)."""
    rng = np.random.default_rng(5)
    b, h, s, d = 3, 2, 256, 32
    q, k, v = _qkv(rng, b, h, s, s, d)
    keys = np.arange(s)
    mask = np.stack([((keys >= 64) & (keys < 128)) | (keys >= 200),
                     np.zeros(s, dtype=bool), keys < 150])
    scale = 1.0 / 96 ** 0.5
    bias = jnp.where(jnp.asarray(mask), 0.0, -1e30).astype(jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        want, want_lse, _ = jax_flash_forward(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias,
            jnp.int32(0), causal, s, 64, 0.0, scale, True)
    got, lse = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v),
                               key_padding_mask=torch.from_numpy(mask),
                               causal=causal, sm_scale=scale,
                               return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(want_lse)[:, :, :s, 0], **TOL)
    assert np.all(got.numpy()[1] == 0.0)
    assert np.all(lse.numpy()[1] == np.float32(-1e30))


def test_dense_weights_match_jax():
    """``return_weights=True`` takes the dense path: head-averaged weights."""
    rng = np.random.default_rng(1)
    q, k, v = _qkv(rng, 2, 4, 1, 48, 16)
    mask = rng.random((2, 48)) < 0.7
    out, w = dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        key_padding_mask=torch.from_numpy(mask), return_weights=True)
    want_o, want_w = jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             key_padding_mask=jnp.asarray(mask),
                             return_weights=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_o), **TOL)
    np.testing.assert_allclose(w.numpy(), np.asarray(want_w), **TOL)


@pytest.mark.parametrize("case", ["self_step", "cross", "fully_masked_row"])
def test_decode_plain_matches_jax_kernel(case):
    """The self-attention step reads a strided view of the cache cut to
    pos + 1 keys; JAX reads the whole cache under the mask arange <= pos."""
    rng = np.random.default_rng(2)
    b, h, s, d = 3, 4, 80, 32
    q = rng.normal(size=(b, h, 1, d)).astype(np.float32)
    k = rng.normal(size=(b, h, s, d)).astype(np.float32)
    v = rng.normal(size=(b, h, s, d)).astype(np.float32)
    scale = 1.0 / 96 ** 0.5
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    if case == "self_step":
        pos = 37
        mask = np.broadcast_to(np.arange(s)[None, :] <= pos, (b, s))
        got = decode_attention(tq, tk[:, :, :pos + 1], tv[:, :, :pos + 1],
                               None, sm_scale=scale)
    else:
        mask = rng.random((b, s)) < 0.6
        if case == "fully_masked_row":
            mask[1] = False
        got = decode_attention(tq, tk, tv, torch.from_numpy(mask),
                               sm_scale=scale)
    want = jax_decode_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(mask),
                                sm_scale=scale, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if case == "fully_masked_row":
        assert np.all(got.numpy()[1] == 0.0)


def test_line_segment_mean_matches_jax():
    rng = np.random.default_rng(3)
    memory = rng.normal(size=(2, 40, 16)).astype(np.float32)
    ttl = rng.integers(0, 12, size=(2, 40)).astype(np.int32)
    means, counts = line_segment_mean(torch.from_numpy(memory),
                                      torch.from_numpy(ttl), 16)
    want_m, want_c = jax_segmean(jnp.asarray(memory), jnp.asarray(ttl), 16)
    np.testing.assert_allclose(means.numpy(), np.asarray(want_m), **TOL)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_c))


@pytest.mark.parametrize("shape,k,p", [((4, 503), 50, 0.95), ((2, 64), 8, 0.5),
                                       ((3, 40), 5, 1.0), ((2, 30), 0, 0.9)])
def test_top_k_top_p_filter_matches_jax(shape, k, p):
    logits = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    got = sampling.top_k_top_p_filter(torch.from_numpy(logits), k, p)
    want = jax_sampling.top_k_top_p_filter(jnp.asarray(logits), k, p)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_penalize_repetition_matches_jax():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(3, 20)).astype(np.float32)
    prev = np.asarray([0, 7, 19], np.int32)
    got = sampling.penalize_repetition(torch.from_numpy(logits),
                                       torch.from_numpy(prev), 1.5)
    want = jax_sampling.penalize_repetition(jnp.asarray(logits),
                                            jnp.asarray(prev), 1.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sampler_distribution_matches_jax_filter():
    """Draws from a torch.Generator fall in the JAX-filtered support with
    frequencies within 5 binomial sigmas of its probabilities."""
    rng = np.random.default_rng(6)
    logits = rng.normal(0, 2, (1, 257)).astype(np.float32)
    k, p, n = 8, 0.9, 20_000
    probs = np.asarray(jax.nn.softmax(jax_sampling.top_k_top_p_filter(
        jnp.asarray(logits), k, p), -1))[0]
    support = set(np.flatnonzero(probs > 1e-9).tolist())
    draws = sampling.sample_top_k_top_p(
        torch.from_numpy(np.repeat(logits, n, axis=0)), k, p,
        generator=torch.Generator().manual_seed(0)).numpy()
    assert set(draws.tolist()) <= support
    freq = np.bincount(draws, minlength=257) / n
    for t in support:
        sd = (probs[t] * (1 - probs[t]) / n) ** 0.5
        assert abs(freq[t] - probs[t]) < 5 * sd + 1e-4, (t, freq[t], probs[t])


def test_flash_wrapper_refuses_training_options():
    """The wrapper refuses an attention dropout rate of 1 or more, on every
    device (a rate below 1 is taken: see the test below)."""
    x = torch.zeros(1, 1, 4, 8)
    with pytest.raises(ValueError, match="dropout"):
        flash_attention(x, x, x, dropout_rate=1.0)
    with pytest.raises(ValueError, match="dropout"):
        flash_attention(x, x, x, dropout_rate=1.5, seed=3)


def test_flash_wrapper_takes_dropout_and_returns_lse():
    """The wrapper takes attention dropout and returns the f32 row LSE,
    here against ``logsumexp`` of JAX's masked scores."""
    rng = np.random.default_rng(8)
    q, k, v = _qkv(rng, 2, 2, 24, 40, 16)
    mask = np.arange(40)[None, :] < np.asarray([33, 0])[:, None]
    out, lse = flash_attention(*map(torch.from_numpy, (q, k, v)),
                               key_padding_mask=torch.from_numpy(mask),
                               dropout_rate=0.2, seed=5, return_lse=True)
    scores = (jnp.einsum("bhqd,bhkd->bhqk", q, k) / 16 ** 0.5
              + jnp.where(jnp.asarray(mask)[:, None, None, :], 0.0, -1e30))
    want = jax.nn.logsumexp(scores, axis=-1)
    assert out.shape == (2, 2, 24, 16) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(want), **TOL)
    assert np.all(out.numpy()[1] == 0.0)       # the fully-masked batch row


def _jax_seed(key) -> int:
    """The seed JAX's mha_reference draws from its dropout key."""
    return int(jax.random.randint(key, (), 0, jnp.iinfo(jnp.int32).max,
                                  dtype=jnp.int32))


@pytest.mark.parametrize("case", ["key_mask", "causal", "fully_masked_row"])
def test_flash_dropout_matches_jax_reference(case):
    """With attention dropout, the plain version equals JAX's
    ``mha_reference(..., deterministic=False)`` given JAX's own seed for
    that key (the same hash mask over the flat (B, H, Sq, Sk) index), in
    the output and in dq, dk, dv against ``jax.vjp``. f32, 1e-5."""
    rng = np.random.default_rng(9)
    b, h, sq, sk, d = 2, 2, 24, 40, 16
    q, k, v = _qkv(rng, b, h, sq, sk, d)
    g = rng.normal(size=(b, h, sq, d)).astype(np.float32)
    mask = np.arange(sk)[None, :] < np.asarray([sk - 5, 17])[:, None]
    if case == "fully_masked_row":
        mask[1] = False
    causal = case == "causal"
    key = jax.random.PRNGKey(11)
    rate = 0.3

    def jax_fwd(q_, k_, v_):
        return jax_mha(q_, k_, v_, key_padding_mask=jnp.asarray(mask),
                       causal=causal, dropout_rate=rate, deterministic=False,
                       dropout_rng=key)
    want, vjp = jax.vjp(jax_fwd, *map(jnp.asarray, (q, k, v)))
    want_g = vjp(jnp.asarray(g))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = flash_attention(tq, tk, tv, key_padding_mask=torch.from_numpy(mask),
                          causal=causal, dropout_rate=rate,
                          seed=_jax_seed(key))
    got_g = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for name, a, w in zip(("dq", "dk", "dv"), got_g, want_g):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)
    if case == "fully_masked_row":
        assert np.all(got_g[0].numpy()[1] == 0.0)


@pytest.mark.parametrize("block_k,causal", [(256, False), (128, True)])
def test_flash_gradient_matches_jax_kernel(block_k, causal):
    """The plain version's gradient (autograd through ``mha_reference``)
    equals ``jax.grad`` through JAX's Pallas flash kernels in interpret
    mode: block_k >= Sk is the fused K2 backward (nk == 1), block_k < Sk
    the K3/K4 pair (nk == 2). f32, 1e-5."""
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, 1, 2, 256, 256, 64)
    mask = rng.random((1, 256)) < 0.85
    mask[:, 0] = True
    g = rng.normal(size=q.shape).astype(np.float32)

    def flash_loss(q_, k_, v_):
        out = jax_flash_attention(q_, k_, v_,
                                  key_padding_mask=jnp.asarray(mask),
                                  causal=causal, block_q=128,
                                  block_k=block_k)
        return jnp.sum(out * jnp.asarray(g))
    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(flash_loss, argnums=(0, 1, 2))(
            *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = flash_attention(tq, tk, tv, key_padding_mask=torch.from_numpy(mask),
                          causal=causal)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)
