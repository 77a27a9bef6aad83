"""The PyTorch port's model against the JAX model, same weights, on the CPU.

Tiny configuration (d=64, 4 heads, 2+2 layers, FFN 128, L=64, 64 line slots,
f32, dropout off). The flax parameter tree (its structure from
``jax.eval_shape`` of the JAX initialiser) is filled from a numpy seed,
carried over with ``convert_flax_params``, and the same numpy inputs go
through both models.
Tolerance 1e-4 (rtol and atol): the bar the JAX package held against the
torch reference; f32 sums in another order differ by ~1e-6 here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sct_gan_tpu.config import ModelConfig
from sct_gan_tpu.infer.generate import _init_caches
from sct_gan_tpu.models.sct_transformer import \
    SmartContractTransformer as JaxModel
from sct_gan_tpu_torch import SmartContractTransformer, convert_flax_params

CFG = ModelConfig(d_model=64, nhead=4, num_encoder_layers=2,
                  num_decoder_layers=2, dim_feedforward=128, dropout=0.0,
                  max_length=64, max_lines=64, vocab_size=512, use_gan=True,
                  compute_dtype="float32", use_flash_attention=False)
TOL = dict(rtol=1e-4, atol=1e-4)


def _batch(seed=0, b=2, s=64):
    """Token ids with padded tails and a monotone token→line map."""
    rng = np.random.default_rng(seed)
    lengths = [s - 5, s // 2][:b]
    mask = (np.arange(s)[None, :] < np.asarray(lengths)[:, None])
    ids = np.where(mask, rng.integers(4, CFG.vocab_size, (b, s)), 0)
    ast_mask = (np.arange(s)[None, :] < np.asarray([s // 3, s - 1])[:b, None])
    ast_ids = np.where(ast_mask, rng.integers(4, CFG.vocab_size, (b, s)), 0)
    steps = rng.random((b, s)) < 0.25
    ttl = np.where(mask, np.cumsum(steps, axis=1), 0)
    return {"input_ids": ids.astype(np.int32),
            "attention_mask": mask.astype(np.int32),
            "ast_input_ids": ast_ids.astype(np.int32),
            "ast_attention_mask": ast_mask.astype(np.int32),
            "token_to_line": ttl.astype(np.int32)}


def _t(batch):
    return {k: torch.from_numpy(v.astype(np.int64)) for k, v in batch.items()}


def flax_params(cfg, seed=0):
    """A flax parameter tree for ``cfg`` with numpy-seeded values: kernels
    ~ N(0, 1/fan_in), vectors ~ N(0, 0.1), LayerNorm scales ~ 1 + N(0, 0.1)
    (non-trivial everywhere, so a mis-mapped leaf shows)."""
    jm = JaxModel(cfg)
    dummy = jnp.zeros((1, cfg.max_length), jnp.int32)
    shapes = jax.eval_shape(lambda k: jm.init(
        {"params": k}, dummy, jnp.ones_like(dummy), dummy,
        jnp.ones_like(dummy), target_ids=dummy, token_to_line=dummy,
        deterministic=True)["params"], jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        if len(s.shape) == 2:
            return rng.normal(0, s.shape[0] ** -0.5, s.shape).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + rng.normal(0, 0.1, s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def pair():
    params = flax_params(CFG)
    tm = SmartContractTransformer(CFG, seed=None)
    tm.load_state_dict(convert_flax_params(params, CFG))
    return JaxModel(CFG), params, tm.eval()


@pytest.fixture(scope="module")
def forward_pair(pair):
    """Both full forwards (teacher-forced, with line heads) on one batch."""
    jm, params, tm = pair
    b = _batch(seed=1)
    want = jax.jit(lambda p, b: jm.apply(
        {"params": p}, **b, target_ids=b["input_ids"],
        deterministic=True))(params, b)
    tb = _t(b)
    with torch.no_grad():
        got = tm(**tb, target_ids=tb["input_ids"])
    return b, want, got


def test_encode_memory_matches_jax(forward_pair):
    _, want, got = forward_pair
    np.testing.assert_allclose(got["memory"].numpy(),
                               np.asarray(want["memory"]), **TOL)


@pytest.mark.parametrize("key", [
    "contract_vulnerability_logits", "contract_attn_weights",
    "line_vulnerability_logits", "logits", "discriminator_logits",
    "encoder_output"])
def test_forward_heads_match_jax(forward_pair, key):
    """Full forward: contract logits and pooling weights, line logits,
    shifted LM logits, the discriminator, the pooled encoder output."""
    _, want, got = forward_pair
    np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                               **TOL)
    np.testing.assert_array_equal(got["target_ids"].numpy(),
                                  np.asarray(want["target_ids"]))


def test_line_head_per_sample_counts_matches_jax(pair, forward_pair):
    """The per-sample line-count option (each row masks its own count)."""
    _, params, tm = pair
    b, want, got = forward_pair
    cfg = CFG.__class__(**{**CFG.__dict__, "per_sample_line_counts": True})
    jm = JaxModel(cfg)
    want_l = jax.jit(lambda p, m, t: jm.apply(
        {"params": p}, m, t, method=jm.line_head))(
            params, want["memory"], b["token_to_line"])
    tm.config = cfg
    try:
        with torch.no_grad():
            got_l = tm.line_head(got["memory"],
                                 torch.from_numpy(b["token_to_line"]))
    finally:
        tm.config = CFG
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **TOL)


def test_decode_step_matches_jax(pair):
    """KV-cached decode over a fixed 8-token prefix: per-step f32 logits
    equal JAX's ``decode_step`` and the port's own teacher-forced logits."""
    jm, params, tm = pair
    b = _batch(seed=2)
    rng = np.random.default_rng(3)
    prefix = rng.integers(4, CFG.vocab_size, (2, 8)).astype(np.int32)
    src_mask = b["attention_mask"].astype(bool)
    memory = jax.jit(lambda p, i, m: jm.apply({"params": p}, i, m,
                                              method=jm.encode))(
        params, b["input_ids"], b["attention_mask"])
    cross = jm.apply({"params": params}, memory,
                     method=jm.precompute_cross_kv)
    step = jax.jit(lambda p, t, pos, c, x, m: jm.apply(
        {"params": p}, t, pos, c, x, m, method=jm.decode_step))
    caches = _init_caches(CFG, 2, dtype=memory.dtype)
    tb = _t(b)
    with torch.no_grad():
        tmem = tm.encode(tb["input_ids"], tb["attention_mask"])
        tcross = tm.precompute_cross_kv(tmem)
        tcaches = tm.init_decode_cache(2)
        tsrc = torch.from_numpy(src_mask)
        full = tm.decode_teacher_forced(torch.from_numpy(prefix).long(), tmem,
                                        tsrc)
        for pos in range(prefix.shape[1]):
            want, caches = step(params, prefix[:, pos:pos + 1],
                                jnp.int32(pos), caches, cross, src_mask)
            got = tm.decode_step(torch.from_numpy(prefix[:, pos:pos + 1]),
                                 pos, tcaches, tcross, tsrc)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
            np.testing.assert_allclose(got.numpy(), full[:, pos].numpy(),
                                       **TOL)


def test_converter_rejects_leftovers(pair):
    """A flax leaf the port has no place for, or a port parameter the tree
    lacks, raises; a wrong shape raises."""
    _, params, _ = pair
    tree = jax.tree_util.tree_map(np.asarray, params)
    extra = {**tree, "stray": {"kernel": np.zeros((2, 2), np.float32)}}
    with pytest.raises(ValueError, match="stray"):
        convert_flax_params(extra, CFG)
    missing = {k: v for k, v in tree.items() if k != "output_norm"}
    with pytest.raises(ValueError, match="output_norm"):
        convert_flax_params(missing, CFG)
    bad = {**tree, "empty_line_embedding": np.zeros(3, np.float32)}
    with pytest.raises(ValueError, match="shape"):
        convert_flax_params(bad, CFG)


def test_init_follows_jax_distributions():
    """Seeded initialisation matches the JAX initialisers in distribution:
    xavier-uniform bounds, normal(0.02) embeddings, the line head's final
    bias -0.2, zero empty-line embedding, unit LayerNorm scales."""
    cfg = ModelConfig(d_model=128, nhead=4, num_encoder_layers=1,
                      num_decoder_layers=1, dim_feedforward=256,
                      max_length=32, max_lines=32, vocab_size=512,
                      compute_dtype="float32")
    m = SmartContractTransformer(cfg, seed=0)
    w = m.encoder.layer_0.ffn.linear1.weight
    bound = (6.0 / (128 + 256)) ** 0.5
    assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound
    assert abs(m.embedding.weight.std().item() - 0.02) < 1e-3
    head = m.line_vulnerability_head_1
    assert torch.all(head.dense_2.bias == -0.2)
    assert abs(head.dense_2.weight.std().item() - 0.1) < 0.01
    assert torch.all(m.empty_line_embedding == 0)
    assert torch.all(m.output_norm.weight == 1)
    again = SmartContractTransformer(cfg, seed=0)
    assert torch.equal(again.output_layer.weight, m.output_layer.weight)


def test_training_mode_dropout_raises():
    """Training mode with dropout raises when the forward is given no seed
    generator, in the encoder and in the full forward."""
    cfg = CFG.__class__(**{**CFG.__dict__, "dropout": 0.1})
    m = SmartContractTransformer(cfg, seed=0)      # torch modules start in train
    b = _t(_batch())
    with pytest.raises(RuntimeError, match="generator"):
        m.encode(b["input_ids"], b["attention_mask"])
    with pytest.raises(RuntimeError, match="generator"):
        m(**b, target_ids=b["input_ids"])


def test_training_mode_dropout_is_reproducible():
    """Training mode with dropout, given a seed generator, gives a finite
    output that differs from eval mode and is reproduced by the same
    generator seed."""
    cfg = CFG.__class__(**{**CFG.__dict__, "dropout": 0.1})
    m = SmartContractTransformer(cfg, seed=0)      # torch modules start in train
    b = _t(_batch())

    def run(seed):
        with torch.no_grad():
            return m(**b, target_ids=b["input_ids"],
                     generator=torch.Generator().manual_seed(seed))
    first, again, other = run(0), run(0), run(1)
    m.eval()
    with torch.no_grad():
        ref = m(**b, target_ids=b["input_ids"])
    for key in ("memory", "logits", "line_vulnerability_logits",
                "contract_vulnerability_logits", "discriminator_logits"):
        assert torch.isfinite(first[key]).all(), key
        assert torch.equal(first[key], again[key]), key
        assert not torch.equal(first[key], ref[key]), key
        assert not torch.equal(first[key], other[key]), key
