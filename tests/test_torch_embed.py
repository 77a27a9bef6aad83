"""The port's ``embedding_lookup`` against the JAX package's sorted-backward
``custom_vjp`` (``sct_gan_tpu/ops/embed.py``), on the CPU.

Ids with many duplicates (a 12-row table, 96 ids), f32: the forward is the
same gather, bit for bit; the table's gradient is the per-id sum of the
output gradient rows on both sides, summed in another order: 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from sct_gan_tpu.ops.embed import embedding_lookup as jax_lookup
from sct_gan_tpu_torch.ops.embed import embedding_lookup


def test_embedding_lookup_matches_jax_at_duplicate_ids():
    rng = np.random.default_rng(0)
    table = rng.normal(size=(12, 8)).astype(np.float32)
    ids = rng.integers(0, 5, (4, 24)).astype(np.int32)   # 5 of 12 rows used
    g = rng.normal(size=(4, 24, 8)).astype(np.float32)
    want, vjp = jax.vjp(lambda t: jax_lookup(t, jnp.asarray(ids)),
                        jnp.asarray(table))
    (want_g,) = vjp(jnp.asarray(g))
    t = torch.from_numpy(table).requires_grad_()
    got = embedding_lookup(t, torch.from_numpy(ids))
    (got_g,) = torch.autograd.grad(got, t, torch.from_numpy(g))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-6,
                               atol=1e-6)
    assert np.all(got_g.numpy()[5:] == 0.0)          # unused rows: nothing
