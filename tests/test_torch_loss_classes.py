"""The port's class-style losses against the JAX package's, on the CPU.

Same numpy inputs, f32, 1e-5 (rtol and atol) as in ``test_torch_train.py``:
the same math summed in another order. Covers the mutable attributes the
trainer retunes and the spatial loss's flattened (B·S, C) convention.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sct_gan_tpu.data.synthetic import generate_corpus
from sct_gan_tpu.losses import classes as jcls
from sct_gan_tpu_torch.data.tokenizer import SolidityTokenizer
from sct_gan_tpu_torch.losses import (ContractLevelFocalLoss, FocalLoss,
                                      SoliditySyntaxLoss,
                                      SpatialAwareFocalLoss)
from sct_gan_tpu_torch.losses import classes as tcls

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    b, s, c = 2, 32, 8
    return dict(pred=rng.normal(0, 2, (b, s, c)).astype(np.float32),
                target=(rng.random((b, s, c)) < 0.1).astype(np.float32),
                ttl=np.cumsum(rng.random((b, s)) < 0.2, 1).astype(np.int32))


def _both(make, *arrays):
    """(port value, JAX value) of the loss ``make(module)`` on arrays."""
    port = make(tcls)(*map(torch.from_numpy, arrays))
    want = make(jcls)(*map(jnp.asarray, arrays))
    return float(port), float(want)


@pytest.mark.parametrize("reduction", ["mean", "sum"])
def test_focal_and_contract_losses_match_jax(inputs, reduction):
    p, t = inputs["pred"], inputs["target"]
    got, want = _both(lambda m: m.FocalLoss(0.3, 1.5, reduction), p, t)
    np.testing.assert_allclose(got, want, **TOL)
    got, want = _both(lambda m: m.ContractLevelFocalLoss(
        reduction=reduction), p[:, 0], t[:, 0])
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("flat", [False, True])
def test_spatial_loss_matches_jax_after_a_retune(inputs, flat):
    """Alpha, gamma and the spatial weight are retuned on the instance
    (as the trainer does) before the call."""
    p, t, ttl = inputs["pred"], inputs["target"], inputs["ttl"]
    if flat:      # the reference's (B·S, C) + (S,) calling convention
        p, t, ttl = p.reshape(-1, 8), t.reshape(-1, 8), ttl[0]

    def make(m):
        loss = m.SpatialAwareFocalLoss()
        loss.alpha, loss.gamma, loss.spatial_weight = 0.1, 1.5, 0.1
        return loss
    got, want = _both(make, p, t, ttl)
    np.testing.assert_allclose(got, want, **TOL)
    assert isinstance(make(tcls), SpatialAwareFocalLoss)


def test_syntax_loss_matches_jax():
    tok = SolidityTokenizer(vocab_size=96)
    codes = [r["source_code"] for r in generate_corpus(n=2, seed=3)]
    ids = np.asarray(tok(codes, max_length=48, padding="max_length",
                         truncation=True, return_tensors="np")["input_ids"],
                     np.int64) % 96
    logits = np.random.default_rng(1).normal(size=(2, 48, 96)).astype(
        np.float32)
    got = SoliditySyntaxLoss(tok, syntax_weight=0.7)(
        torch.from_numpy(logits), torch.from_numpy(ids))
    want = jcls.SoliditySyntaxLoss(tok, syntax_weight=0.7)(
        jnp.asarray(logits), jnp.asarray(ids))
    np.testing.assert_allclose(float(got), float(want), **TOL)
    assert FocalLoss().alpha == 0.25 and ContractLevelFocalLoss().gamma == 4.0
