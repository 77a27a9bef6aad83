"""Head dims over 128 on the CPU, against the JAX package.

The wrappers' CPU routes (their plain versions) at head dims 192, 256 and
384 against JAX's Pallas flash kernel, which pads any head dim to a
multiple of 128 lanes, and its decode kernel, both in interpret mode, with
the tolerance of ``test_torch_head_dims.py`` (1e-5 in f32: the same math
summed in another order); the wrappers' head-dim routing (the flash
kernels' 192 and 256 instances and chunks of them over 256, K5's 192
instance and its wide-head route in 128-column chunks over 192); and
a tiny model with one 256-wide head
against JAX's detection (1e-4, the analyzer tests' bar).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sct_gan_tpu.config import ModelConfig as JaxModelConfig
from sct_gan_tpu.infer import SmartContractAnalyzer as JaxAnalyzer
from sct_gan_tpu.ops.decode_attention import \
    decode_attention as jax_decode_attention
from sct_gan_tpu.ops.flash_attention import \
    flash_attention as jax_flash_attention
from sct_gan_tpu_torch import SmartContractAnalyzer, convert_flax_params
from sct_gan_tpu_torch.config import ModelConfig
from sct_gan_tpu_torch.data.tokenizer import SolidityTokenizer
from sct_gan_tpu_torch.ops.decode_attention import (
    WIDE_CHUNK, decode_attention, decode_head_dim, decode_layout,
    decode_runs_on_kernel)
from sct_gan_tpu_torch.ops.flash_attention import (
    _check_shapes, flash_attention, flash_attention_reference,
    kernel_head_dim, kernel_route, pad_head_dim, runs_on_kernel)
from test_torch_head_dims import TOL, _qkv
from test_torch_model import flax_params

WIDE_DIMS = [192, 256, 384]


@pytest.mark.parametrize("d", WIDE_DIMS)
def test_flash_wide_head_dims_match_jax(d):
    """Forward and dq, dk, dv of the CPU route, causal and under a key
    mask, against the Pallas kernel in interpret mode."""
    q, k, v, mask = _qkv(d, sq=24, sk=40)
    dout = np.random.default_rng(d).normal(size=q.shape).astype(np.float32)
    for causal in (False, True):
        def jax_loss(q_, k_, v_):
            out = jax_flash_attention(q_, k_, v_, causal=causal,
                                      key_padding_mask=jnp.asarray(mask))
            return jnp.sum(out * dout), out
        with pltpu.force_tpu_interpret_mode():
            (_, want), want_g = jax.value_and_grad(
                jax_loss, argnums=(0, 1, 2), has_aux=True)(
                    jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
        got = flash_attention(tq, tk, tv, causal=causal,
                              key_padding_mask=torch.from_numpy(mask))
        got_g = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(dout))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **TOL)
        for name, g, w in zip(("dq", "dk", "dv"), got_g, want_g):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       err_msg=f"{name} causal={causal}",
                                       **TOL)


@pytest.mark.parametrize("d", WIDE_DIMS)
def test_decode_wide_head_dims_match_jax(d):
    rng = np.random.default_rng(d)
    b, h, s = 3, 2, 70
    q = rng.normal(size=(b, h, 1, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, h, s, d)).astype(np.float32)
            for _ in range(2))
    mask = rng.random((b, s)) < 0.6
    mask[1] = False
    got = decode_attention(*map(torch.from_numpy, (q, k, v)),
                           torch.from_numpy(mask), sm_scale=d ** -0.5)
    want = jax_decode_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(mask),
                                sm_scale=d ** -0.5, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert np.all(got.numpy()[1] == 0.0)


@pytest.mark.parametrize("d,want", [(129, 192), (192, 192), (256, 256),
                                    (320, 384), (384, 384), (768, 768)])
def test_kernel_head_dim_takes_the_wide_route(d, want):
    """No head dim raises: the wrappers pad to the flash kernels' head dim
    (an instance up to 256, a multiple of 256 or 192 above), which their
    shape check takes. K5 computes at the same head dims here (its 192
    instance, the next multiple of 128 over 192), and its shape check
    takes them."""
    assert kernel_head_dim(d) == want and runs_on_kernel(want)
    assert runs_on_kernel(d) == (d == want)
    q = torch.empty(2, 3, 1, want, dtype=torch.bfloat16, device="meta")
    k = torch.empty(2, 3, 50, want, dtype=torch.bfloat16, device="meta")
    assert _check_shapes(q, k, k, 0.0)[4] == want
    dw = decode_head_dim(d)
    assert dw == want
    q = torch.empty(2, 3, 1, dw, dtype=torch.bfloat16, device="meta")
    k = torch.empty(2, 3, 50, dw, dtype=torch.bfloat16, device="meta")
    assert decode_layout(q, k, k)[1] == (3 * 50 * dw, 50 * dw, dw)


@pytest.mark.parametrize("d,route", [(160, (192, 1)), (192, (192, 1)),
                                     (224, (256, 1)), (256, (256, 1)),
                                     (320, (192, 2)), (384, (192, 2)),
                                     (512, (256, 2))])
def test_flash_routes_wide_head_dims_to_instances_and_chunks(d, route):
    """Up to 256 the next instance in one chunk; over 256 the smallest
    multiple of 256 or 192 that holds the head dim, 256 where both do."""
    assert kernel_route(d) == route
    assert kernel_head_dim(d) == route[0] * route[1]


@pytest.mark.parametrize("d,want", [(160, 192), (192, 192), (224, 256),
                                    (256, 256), (320, 384), (384, 384),
                                    (512, 512)])
def test_decode_routes_to_its_instances_up_to_192_and_chunks_above(d, want):
    """K5 computes a head dim up to 192 on the smallest of its instances
    that holds it, and over 192 in 128-column chunks (224 and 320 with a
    last chunk part full); a multiple of 8 runs in place, with no copy."""
    assert decode_head_dim(d) == want
    assert want <= 192 or want % WIDE_CHUNK == 0
    assert decode_runs_on_kernel(want) and decode_runs_on_kernel(d)


@pytest.mark.parametrize("d", [200, 320, 448])
def test_a_head_dim_no_route_takes_raises(d):
    """The kernels' shape check refuses a head dim that is neither an
    instance nor a multiple of 256 or 192 over 256; nothing falls back."""
    q = torch.empty(2, 3, 8, d, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="head dim"):
        _check_shapes(q, q, q, 0.0)


@pytest.mark.parametrize("d", [160, 192, 224, 320])
def test_wide_padded_route_gives_the_unpadded_result(d):
    """A wide head dim that is neither an instance nor a multiple of 256
    or 192 goes through a copy padded with zero columns (192 is its own
    instance, so its copy adds none); with the true head dim's scale and
    the output sliced back, the result and the gradients are the
    unpadded ones."""
    q, k, v, mask = _qkv(d, seed=4, sq=16, sk=24)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tmask = torch.from_numpy(mask)
    want = flash_attention_reference(tq, tk, tv, key_padding_mask=tmask)
    dk = kernel_head_dim(d)
    assert dk == {160: 192, 192: 192, 224: 256, 320: 384}[d]
    got = flash_attention_reference(
        *(pad_head_dim(t, dk) for t in (tq, tk, tv)), key_padding_mask=tmask,
        sm_scale=d ** -0.5)[..., :d]
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               **TOL)
    dout = torch.randn(want.shape, generator=torch.Generator().manual_seed(1))
    for a, b in zip(torch.autograd.grad(got, (tq, tk, tv), dout),
                    torch.autograd.grad(want, (tq, tk, tv), dout)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_model_with_a_256_wide_head_matches_jax_detection():
    """d=256 with one head (head dim 256), 1+1 layers: the port's
    detection equals the JAX analyzer's on the same weights."""
    kw = dict(d_model=256, nhead=1, num_encoder_layers=1,
              num_decoder_layers=1, dim_feedforward=64, dropout=0.0,
              max_length=32, max_lines=32, vocab_size=256, use_gan=True,
              compute_dtype="float32")
    jcfg = JaxModelConfig(use_flash_attention=False, **kw)
    cfg = ModelConfig(**kw)
    tok = SolidityTokenizer(vocab_size=256)
    params = flax_params(jcfg, seed=5)
    jax_an = JaxAnalyzer(model_config=jcfg, tokenizer=tok, params=params,
                         verbose=False)
    port = SmartContractAnalyzer(model_config=cfg, tokenizer=tok,
                                 params=convert_flax_params(params, cfg),
                                 device="cpu", verbose=False)
    assert port.model.encoder.layer_0.self_attn.head_dim == 256
    code = "pragma solidity ^0.8.0;\ncontract A {\n  uint x;\n}\n"
    got, want = (a.detect_vulnerabilities(code) for a in (port, jax_an))
    for key in ("contract_probabilities", "line_probabilities"):
        np.testing.assert_allclose(np.asarray(got[key]),
                                   np.asarray(want[key]), rtol=0, atol=1e-4)
