"""The port's hash dropout against the JAX package's, on the CPU.

On the CPU ``dropout`` runs its plain version, ``dropout_reference``; the
kernel (``csrc/dropout.cu``) draws the same stream and is held against the
plain version on the card (``test_torch_kernels.py``, ``chip_smoke.py``).
The masks and values must equal JAX's ``_hash_dropout`` bit for bit, in
f32 and bf16, forward and backward: the hash is integer arithmetic, and the
kept values are one multiply by ``1/(1-rate)`` rounded to x's dtype.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sct_gan_tpu.ops.dropout import _hash_dropout, _hash_keep, fast_dropout
from sct_gan_tpu_torch.ops.dropout import (SEED_HIGH, dropout,
                                           dropout_reference, hash_keep)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("rate,seed", [(0.1, 7), (0.3, SEED_HIGH - 1)])
def test_dropout_matches_jax_bit_for_bit(dtype, rate, seed):
    """Forward and gradient equal ``_hash_dropout`` exactly, on a ragged
    shape, with a seed near the top of JAX's randint range (the uint32
    products wrap)."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 37, 64)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    jx = jnp.asarray(x, jdt)
    want, vjp = jax.vjp(lambda a: _hash_dropout(a, jnp.int32(seed), rate), jx)
    (want_g,) = vjp(jnp.asarray(g, jdt))

    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    got = dropout(tx, rate, seed)
    (got_g,) = torch.autograd.grad(got, tx, torch.from_numpy(g).to(tdt))
    assert got.dtype == tdt and got_g.dtype == tdt
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(want, np.float32))
    np.testing.assert_array_equal(got_g.float().numpy(),
                                  np.asarray(want_g, np.float32))


def test_hash_keep_matches_jax():
    """The keep mask alone, over the flat index of a 2-D shape."""
    for rate, seed in ((0.06, 0), (0.3, 123456789), (0.5, SEED_HIGH - 1)):
        want = np.asarray(_hash_keep((33, 100), jnp.int32(seed), rate))
        got = hash_keep(33 * 100, seed, rate).view(33, 100).numpy()
        np.testing.assert_array_equal(got, want)


def test_rate_zero_and_one_follow_fast_dropout():
    """rate 0 is the identity (the same tensor), rate 1 gives zeros, as
    JAX's ``fast_dropout`` does."""
    x = torch.randn(4, 16)
    key = jax.random.PRNGKey(0)
    jx = jnp.asarray(x.numpy())
    assert dropout(x, 0.0, 3) is x
    assert bool((fast_dropout(jx, 0.0, key) == jx).all())
    assert torch.equal(dropout(x, 1.0, 3), torch.zeros_like(x))
    assert bool((fast_dropout(jx, 1.0, key) == 0).all())


@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_keep_rate_within_three_sigma(rate):
    """Over 2^17 elements the kept share is within 3 binomial sigmas of
    1 - rate, and kept values are scaled by 1/(1 - rate)."""
    n = 1 << 17
    x = torch.ones(n)
    y = dropout_reference(x, 99, rate)
    kept = (y != 0).float().mean().item()
    sigma = (rate * (1 - rate) / n) ** 0.5
    assert abs(kept - (1 - rate)) < 3 * sigma, (kept, sigma)
    assert torch.allclose(y[y != 0], torch.tensor(1 / (1 - rate)))
