"""The kernels' plain versions at head dims 64, 80 and 128 against JAX's.

On the CPU the wrappers run their plain versions; the JAX side runs its
Pallas flash kernel (which pads any head dim to 128 lanes) and its decode
kernel in interpret mode, with gradients through the flash kernel's
custom VJP. Also, on the CPU, the padded route's arithmetic: a head dim
without an instance padded with zero columns to the next instance gives
the unpadded result with the true head dim's scale. Tolerance 1e-5 (rtol
and atol) in f32, as in ``test_torch_ops.py``: the same math summed in
another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sct_gan_tpu.ops.decode_attention import \
    decode_attention as jax_decode_attention
from sct_gan_tpu.ops.flash_attention import \
    flash_attention as jax_flash_attention
from sct_gan_tpu_torch.ops.decode_attention import (decode_attention,
                                                    decode_layout)
from sct_gan_tpu_torch.ops.flash_attention import (
    KERNEL_HEAD_DIMS, flash_attention, flash_attention_reference,
    kernel_head_dim, pad_head_dim)

TOL = dict(rtol=1e-5, atol=1e-5)
HEAD_DIMS = [64, 80, 128]


def _qkv(d, b=2, h=2, sq=40, sk=72, seed=0):
    rng = np.random.default_rng(seed + d)
    q, k, v = (rng.normal(size=(b, h, s, d)).astype(np.float32)
               for s in (sq, sk, sk))
    mask = np.arange(sk)[None, :] < np.asarray([sk - 5, sk // 3])[:, None]
    return q, k, v, mask


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_head_dims_match_jax(d, causal):
    """Forward and dq, dk, dv of the plain version against the JAX Pallas
    kernel (interpret mode), the default scale 1/sqrt(d)."""
    q, k, v, mask = _qkv(d)
    rng = np.random.default_rng(d)
    dout = rng.normal(size=q.shape).astype(np.float32)

    def jax_loss(q_, k_, v_):
        out = jax_flash_attention(q_, k_, v_, key_padding_mask=jnp.asarray(
            mask), causal=causal)
        return jnp.sum(out * dout), out
    with pltpu.force_tpu_interpret_mode():
        (_, want), want_g = jax.value_and_grad(
            jax_loss, argnums=(0, 1, 2), has_aux=True)(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = flash_attention(tq, tk, tv, key_padding_mask=torch.from_numpy(mask),
                          causal=causal)
    got_g = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(dout))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    for name, g, w in zip(("dq", "dk", "dv"), got_g, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("d", HEAD_DIMS)
def test_decode_head_dims_match_jax(d):
    rng = np.random.default_rng(d)
    b, h, s = 3, 2, 80
    q = rng.normal(size=(b, h, 1, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, h, s, d)).astype(np.float32)
            for _ in range(2))
    mask = rng.random((b, s)) < 0.6
    mask[1] = False
    scale = d ** -0.5
    got = decode_attention(*map(torch.from_numpy, (q, k, v)),
                           torch.from_numpy(mask), sm_scale=scale)
    want = jax_decode_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(mask),
                                sm_scale=scale, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert np.all(got.numpy()[1] == 0.0)


@pytest.mark.parametrize("d,want", [(16, 64), (64, 64), (80, 96), (96, 96),
                                    (100, 128), (128, 128)])
def test_kernel_head_dim_picks_the_next_instance(d, want):
    assert kernel_head_dim(d) == want
    assert KERNEL_HEAD_DIMS == (64, 96, 128, 192, 256)


def test_kernel_head_dim_over_128_raises():
    """Over 128, ``kernel_head_dim`` once raised; it now gives the flash
    kernels' head dim: the 192 or 256 instance, over 256 the smallest
    multiple of 256 or 192 (the chunked route). K5's own shape check takes
    160 (its 192 instance) and 320 (its wide-head route) in place; what it
    still refuses is a head dim that is not a multiple of 8: the wrapper
    pads such a head dim first."""
    assert [kernel_head_dim(d) for d in (129, 160, 192, 256, 384, 400)] == [
        192, 192, 192, 256, 384, 512]
    q = torch.empty(2, 8, 1, 160, dtype=torch.bfloat16, device="meta")
    k = torch.empty(2, 8, 100, 160, dtype=torch.bfloat16, device="meta")
    assert decode_layout(q, k, k)[1] == (8 * 100 * 160, 100 * 160, 160)
    q = torch.empty(2, 8, 1, 320, dtype=torch.bfloat16, device="meta")
    k = torch.empty(2, 8, 100, 320, dtype=torch.bfloat16, device="meta")
    assert decode_layout(q, k, k)[1] == (8 * 100 * 320, 100 * 320, 320)
    q = torch.empty(2, 8, 1, 300, dtype=torch.bfloat16, device="meta")
    k = torch.empty(2, 8, 100, 300, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="multiples of 8"):
        decode_layout(q, k, k)


@pytest.mark.parametrize("d", [48, 80, 112])
def test_padded_route_gives_the_unpadded_result(d):
    """The wrapper's padded route on the plain version: q, k, v padded
    with zero columns to the instance, the true head dim's scale, the
    output sliced back; and the gradients reach the unpadded inputs."""
    q, k, v, mask = _qkv(d, seed=3)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tmask = torch.from_numpy(mask)
    want = flash_attention_reference(tq, tk, tv, key_padding_mask=tmask)
    dk = kernel_head_dim(d)
    padded = [pad_head_dim(t, dk) for t in (tq, tk, tv)]
    assert padded[0].shape[-1] == dk and torch.all(padded[0][..., d:] == 0)
    got = flash_attention_reference(*padded, key_padding_mask=tmask,
                                    sm_scale=d ** -0.5)[..., :d]
    np.testing.assert_allclose(got.detach().numpy(),
                               want.detach().numpy(), **TOL)
    dout = torch.randn(want.shape, generator=torch.Generator().manual_seed(0))
    for a, b in zip(torch.autograd.grad(got, (tq, tk, tv), dout),
                    torch.autograd.grad(want, (tq, tk, tv), dout)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


@pytest.mark.parametrize("d", [64, 128])
def test_decode_layout_takes_the_instances(d):
    q = torch.empty(2, 8, 1, d, dtype=torch.bfloat16, device="meta")
    k = torch.empty(2, 8, 100, d, dtype=torch.bfloat16, device="meta")
    assert decode_layout(q, k, k)[1] == (8 * 100 * d, 100 * d, d)
