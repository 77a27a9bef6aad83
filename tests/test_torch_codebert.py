"""The port's frozen CodeBERT embedder against the JAX package's, on the CPU.

At the tiny shapes of ``TINY`` (d=32, 2 heads, FFN 64, vocab 256; two
layers here, so the layer loop shows), f32: the same numpy-seeded flax
parameters (carried over with ``convert_flax_params`` and a
``CodeBERTConfig``) and the same ids with padded tails go through both
encoders; the outputs agree to 1e-4 (rtol and atol), every position
included. The HF-name converter is held to the JAX ``_convert_hf_weights``
on a synthetic numpy state dict under HF RoBERTa names, leaf for leaf
exactly; and the random-init fallback of ``load_codebert_params`` is
seeded.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sct_gan_tpu.variants import codebert as jcodebert
from sct_gan_tpu_torch.config import CodeBERTConfig
from sct_gan_tpu_torch.convert import convert_flax_params
from sct_gan_tpu_torch.variants.codebert import (FlaxCodeBERT,
                                                 _convert_hf_weights,
                                                 load_codebert_params)
from test_torch_tasc import TINY, TOL, numpy_tree

CB = dataclasses.replace(CodeBERTConfig.from_tasc(TINY), num_layers=2)


def _jax_model(cfg: CodeBERTConfig):
    return jcodebert.FlaxCodeBERT(
        vocab_size=cfg.vocab_size, d_model=cfg.d_model,
        num_layers=cfg.num_layers, num_heads=cfg.num_heads,
        dim_feedforward=cfg.dim_feedforward,
        max_positions=cfg.max_positions)


@pytest.fixture(scope="module")
def params():
    ids = jnp.zeros((1, 8), jnp.int32)
    shapes = jax.eval_shape(lambda k: _jax_model(CB).init(
        {"params": k}, ids, jnp.ones_like(ids))["params"],
        jax.random.PRNGKey(0))
    return numpy_tree(shapes, seed=4)


def test_encoder_matches_jax_with_padded_tails(params):
    rng = np.random.default_rng(0)
    b, s = 3, 32
    lengths = np.asarray([s, 17, 5])
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    ids = np.where(mask, rng.integers(3, CB.vocab_size, (b, s)), 0)
    ids = ids.astype(np.int32)
    want = _jax_model(CB).apply({"params": params}, jnp.asarray(ids),
                                jnp.asarray(mask))
    tm = FlaxCodeBERT.from_config(CB, seed=None)
    tm.load_state_dict(convert_flax_params(params, CB))
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long(), torch.from_numpy(mask))
        # no mask = every key attended
        got_full = tm(torch.from_numpy(ids).long())
    assert got.dtype == torch.float32 and got.shape == (b, s, CB.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want_full = _jax_model(CB).apply({"params": params}, jnp.asarray(ids))
    np.testing.assert_allclose(got_full.numpy(), np.asarray(want_full),
                               **TOL)


def _hf_state_dict(cfg: CodeBERTConfig, seed: int = 5):
    """A synthetic HF RoBERTa state dict (torch layouts, numpy), with the
    extra keys a real one has (the pooler, position ids)."""
    rng = np.random.default_rng(seed)
    d, f = cfg.d_model, cfg.dim_feedforward
    r = lambda *shape: rng.normal(0, 0.1, shape).astype(np.float32)
    hf = {"embeddings.word_embeddings.weight": r(cfg.vocab_size, d),
          "embeddings.position_embeddings.weight": r(cfg.max_positions, d),
          "embeddings.token_type_embeddings.weight": r(1, d),
          "embeddings.LayerNorm.weight": r(d), "embeddings.LayerNorm.bias":
              r(d), "embeddings.position_ids": np.arange(cfg.max_positions),
          "pooler.dense.weight": r(d, d), "pooler.dense.bias": r(d)}
    for i in range(cfg.num_layers):
        p = f"encoder.layer.{i}."
        for name, (o, n) in {"attention.self.query": (d, d),
                             "attention.self.key": (d, d),
                             "attention.self.value": (d, d),
                             "attention.output.dense": (d, d),
                             "intermediate.dense": (f, d),
                             "output.dense": (d, f)}.items():
            hf[p + name + ".weight"], hf[p + name + ".bias"] = r(o, n), r(o)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            hf[p + name + ".weight"], hf[p + name + ".bias"] = r(d), r(d)
    return hf


def test_hf_converter_matches_jax(params):
    hf = _hf_state_dict(CB)
    want = convert_flax_params(
        jcodebert._convert_hf_weights(params, hf, CB.num_layers), CB)
    got = _convert_hf_weights(hf, CB.num_layers)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    tm = FlaxCodeBERT.from_config(CB, seed=None)
    tm.load_state_dict(got)            # strict: every name, every shape


def test_load_codebert_params_falls_back_to_a_seeded_init():
    """No cached model (and no network): a random init of the model's
    shapes from the seed, the same for the same seed."""
    model = FlaxCodeBERT.from_config(CB, seed=None)
    a = load_codebert_params(model, model_name="nonexistent/offline", seed=3)
    b = FlaxCodeBERT.from_config(CB, seed=3).state_dict()
    c = FlaxCodeBERT.from_config(CB, seed=4).state_dict()
    assert a.keys() == model.state_dict().keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["layer_0.intermediate.weight"],
                           c["layer_0.intermediate.weight"])
    # the flax initialisers' scales: normal(0.02) tables, LayerNorm ones
    assert abs(a["embeddings.word_embeddings.weight"].std().item()
               - 0.02) < 0.002
    assert torch.equal(a["layer_1.output_norm.weight"],
                       torch.ones(CB.d_model))
