"""The port's TASC model against the JAX package's, same weights, on the CPU.

Tiny configuration (``TINY``: the one of ``tests/test_tasc.py``, f32,
dropout inactive in eval mode). The flax parameter tree (its structure
from ``jax.eval_shape`` of the JAX initialiser) is filled from a numpy
seed, carried over with ``convert_flax_params`` (which builds the port's
model from the ``TASCConfig``), and the same numpy inputs go through both
models:

  * every output of ``SmartContractVulnerabilityGAN`` (binary and
    multiclass) and of ``detect_vulnerabilities``: 1e-4 (rtol and atol),
    the bar of the port's other forward parity tests;
  * 8 KV-cached ``decode_step``s against a one-key memory (the generation
    case): 1e-4;
  * ``SolidityCodeLoss`` and its gradient: 1e-5 relative (the same f32
    math summed in another order);
  * ``get_vulnerability_explanation``, ``check_solidity_syntax`` and the
    Jaccard on fixed inputs: equal.

Generation samples from a ``torch.Generator`` (other numbers than a JAX
key), so the loop itself is checked for its contract: shape, the pragma
seed, its step count and the stop on token 0.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sct_gan_tpu.config import TASCConfig as JaxTASCConfig
from sct_gan_tpu.variants import tasc as jtasc
from sct_gan_tpu.variants.tasc_trainer import \
    SolidityCodeLoss as JaxSolidityCodeLoss
from sct_gan_tpu_torch.config import TASCConfig
from sct_gan_tpu_torch.convert import convert_flax_params
from sct_gan_tpu_torch.data.tokenizer import SolidityTokenizer
from sct_gan_tpu_torch.variants import (SmartContractVulnerabilityGAN,
                                        SolidityCodeLoss,
                                        generate_vulnerable_code,
                                        get_vulnerability_explanation,
                                        make_tasc_generate_fn)

TINY = TASCConfig(d_model=32, nhead=2, num_layers=1, dim_feedforward=64,
                  dropout=0.1, vocab_size=256, decoder_vocab_size=128,
                  max_gen_length=16, multiclass=True,
                  num_vulnerability_types=4, compute_dtype="float32",
                  codebert_num_layers=1, codebert_nhead=2, codebert_ffn=64,
                  max_length=32)
TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)


def jax_config(cfg: TASCConfig) -> JaxTASCConfig:
    return JaxTASCConfig(**dataclasses.asdict(cfg))


def numpy_tree(shapes, seed: int = 0):
    """A flax tree of ``shapes`` (from ``jax.eval_shape``) filled from a
    numpy seed: kernels and tables ~ N(0, 1/fan_in), vectors ~ N(0, 0.1),
    LayerNorm scales ~ 1 + N(0, 0.1) (non-trivial everywhere, so a
    mis-mapped leaf shows)."""
    rng = np.random.default_rng(seed)

    def fill(path, s):
        if len(s.shape) == 2:
            return rng.normal(0, s.shape[0] ** -0.5, s.shape).astype(
                np.float32)
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + rng.normal(0, 0.1, s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def tasc_flax_params(cfg: TASCConfig, seed: int = 0):
    """Numpy-seeded flax parameters of the JAX TASC model of ``cfg``."""
    jm = jtasc.SmartContractVulnerabilityGAN(jax_config(cfg))
    emb = jnp.zeros((2, 8, cfg.d_model))
    tgt = jnp.zeros((2, 4), jnp.int32)
    shapes = jax.eval_shape(lambda k: jm.init(
        {"params": k}, emb, emb, target_sequence=tgt,
        deterministic=True)["params"], jax.random.PRNGKey(0))
    return numpy_tree(shapes, seed)


def port_model(cfg: TASCConfig, params) -> SmartContractVulnerabilityGAN:
    m = SmartContractVulnerabilityGAN(cfg, seed=None)
    m.load_state_dict(convert_flax_params(params, cfg))
    return m.eval()


@pytest.fixture(scope="module", params=[False, True],
                ids=["binary", "multiclass"])
def pair(request):
    cfg = dataclasses.replace(TINY, multiclass=request.param)
    params = tasc_flax_params(cfg)
    return (cfg, jtasc.SmartContractVulnerabilityGAN(jax_config(cfg)),
            params, port_model(cfg, params))


def _inputs(cfg, seed=0, b=2, s=8, t=6):
    rng = np.random.default_rng(seed)
    ce = rng.normal(0, 1, (b, s, cfg.d_model)).astype(np.float32)
    pe = rng.normal(0, 1, (b, s, cfg.d_model)).astype(np.float32)
    tgt = rng.integers(0, cfg.decoder_vocab_size, (b, t)).astype(np.int32)
    return ce, pe, tgt


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want), **(tol or TOL))


def test_gan_outputs_match_jax(pair):
    """Every output of the composition (encoder, generator, discriminator
    on real and fake, the teacher-forced decoder, and for multiclass the
    classifier's scores, pattern scores, location weights and
    embeddings)."""
    cfg, jm, params, tm = pair
    ce, pe, tgt = _inputs(cfg)
    want = jm.apply({"params": params}, jnp.asarray(ce), jnp.asarray(pe),
                    target_sequence=jnp.asarray(tgt), deterministic=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(ce), torch.from_numpy(pe),
                 target_sequence=torch.from_numpy(tgt).long())
    assert set(got) == set(want)
    for k in want:
        if k == "pattern_scores":
            assert set(got[k]) == set(want[k])
            for p in want[k]:
                _close(got[k][p], want[k][p])
        else:
            assert tuple(got[k].shape) == want[k].shape, k
            _close(got[k], want[k])
    # without a target the decoder reads the 2-token pragma-solidity seed
    want = jm.apply({"params": params}, jnp.asarray(ce), jnp.asarray(pe),
                    deterministic=True)["decoded_code"]
    with torch.no_grad():
        got = tm(torch.from_numpy(ce), torch.from_numpy(pe))["decoded_code"]
    _close(got, want)


def test_detect_vulnerabilities_matches_jax(pair):
    cfg, jm, params, tm = pair
    ce, _, _ = _inputs(cfg, seed=1)
    if not cfg.multiclass:
        with pytest.raises(ValueError, match="multiclass"):
            tm.detect_vulnerabilities(torch.from_numpy(ce))
        return
    want = jm.apply({"params": params}, jnp.asarray(ce),
                    method=jm.detect_vulnerabilities)
    with torch.no_grad():
        got = tm.detect_vulnerabilities(torch.from_numpy(ce))
    assert set(got) == set(want)
    for k in ("vulnerability_scores", "vulnerability_locations",
              "location_embeddings"):
        _close(got[k], want[k])
    for p in want["pattern_scores"]:
        _close(got["pattern_scores"][p], want["pattern_scores"][p])


def test_decode_steps_match_jax(pair):
    """8 KV-cached steps against a one-key memory, no mask: the JAX
    decoder's f32 caches against the port's (compute dtype, f32 here),
    logits step for step."""
    cfg, jm, params, tm = pair
    rng = np.random.default_rng(2)
    memory = rng.normal(0, 1, (2, 1, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.decoder_vocab_size, (2, 8)).astype(np.int32)
    apply = lambda fn, *a: jm.apply({"params": params}, *a, method=fn)
    cross = apply(lambda m, mem: m.decoder.cross_kvs(mem),
                  jnp.asarray(memory))
    caches = apply(lambda m, b: m.decoder.init_cache(b), 2)
    with torch.no_grad():
        tcross = tm.decoder.cross_kvs(torch.from_numpy(memory))
        tcaches = tm.decoder.init_cache(2)
        for pos in range(8):
            want, caches = apply(
                lambda m, *a: m.decoder.decode_step(*a),
                jnp.asarray(toks[:, pos:pos + 1]), pos, caches, cross)
            got = tm.decoder.decode_step(
                torch.from_numpy(toks[:, pos:pos + 1]).long(), pos, tcaches,
                tcross)
            assert got.shape == (2, cfg.decoder_vocab_size)
            _close(got, want)
        # the caches hold what the JAX loop wrote, positions 0..7
        _close(tcaches[-1][0][:, :, :8], caches[-1][0][:, :, :8])


def test_generation_loop():
    """The sampled loop's contract: (B, L) tokens from the pragma seed,
    L - 1 steps unless every row emitted 0, every row past its first 0
    still sampled (the JAX loop does not freeze rows); and the
    noise→code entry point."""
    cfg = TINY
    tm = port_model(cfg, tasc_flax_params(cfg))
    memory = torch.randn(2, 1, cfg.d_model,
                         generator=torch.Generator().manual_seed(0))
    gen = make_tasc_generate_fn(tm, max_length=12)
    tokens = gen(memory, torch.Generator().manual_seed(1))
    assert tokens.shape == (2, 12) and tokens.dtype == torch.long
    assert (tokens[:, 0] == 0).all()
    assert 1 <= gen.last_steps <= 11
    done = (tokens[:, 1:gen.last_steps + 1] == 0).any(dim=1).all()
    assert bool(done) == (gen.last_steps < 11)
    # a decoder whose logits favour token 0 stops after one step
    with torch.no_grad():
        tm.decoder.proj2.bias[0] = 1e4
    tokens = gen(memory, torch.Generator().manual_seed(1))
    assert gen.last_steps == 1 and (tokens == 0).all()

    tm = port_model(cfg, tasc_flax_params(cfg))
    out = generate_vulnerable_code(tm, torch.Generator().manual_seed(0),
                                   num_samples=2,
                                   tokenizer=SolidityTokenizer(
                                       vocab_size=cfg.vocab_size),
                                   max_length=12)
    assert out["tokens"].shape == (2, 12)
    assert isinstance(out["code"], str)
    assert out["vulnerability_scores"].shape == (2, 4)
    assert out["vulnerability_locations"].shape == (2, 1, 1)
    assert out["decode_steps"] >= 1 and not tm.training


def test_vulnerability_explanation_matches_jax():
    scores = {
        "timestamp_dependence": np.array([[0.9, 0.8, 0.1], [0.9, 0.1, 0.1]]),
        "reentrancy": np.array([[0.9, 0.9, 0.9, 0.1], [0.9, 0.9, 0.9, 0.9]]),
        "integer_overflow": np.array([[0.9, 0.1, 0.1], [0.9, 0.6, 0.1]]),
        "dangerous_delegatecall": np.array([[0.9, 0.1], [0.2, 0.1]]),
    }
    for index in (0, 1):
        want = jtasc.get_vulnerability_explanation(scores, index=index)
        assert get_vulnerability_explanation(scores, index=index) == want
        as_tensors = {k: torch.from_numpy(v) for k, v in scores.items()}
        assert get_vulnerability_explanation(as_tensors, index=index) == want
    assert len(get_vulnerability_explanation(scores, 0)) == 4
    assert get_vulnerability_explanation(scores, 1) == []
    row = {k: v[0] for k, v in scores.items()}          # (n,) scores
    assert get_vulnerability_explanation(row) == \
        jtasc.get_vulnerability_explanation(row)


def test_solidity_code_loss_matches_jax():
    """Value and gradient, with ignored (0) and out-of-vocab (clipped)
    targets; the syntax term reads the column of the first target."""
    rng = np.random.default_rng(3)
    logits = rng.normal(0, 2, (2, 8, 64)).astype(np.float32)
    targets = rng.integers(1, 80, (2, 8)).astype(np.int32)
    targets[0, 0], targets[1, 3] = 70, 0
    jloss = JaxSolidityCodeLoss(vocab_size=64)
    want, want_g = jax.value_and_grad(lambda x: jloss(x, jnp.asarray(
        targets)))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    got = SolidityCodeLoss(vocab_size=64)(x, torch.from_numpy(targets))
    (g,) = torch.autograd.grad(got, x)
    np.testing.assert_allclose(got.item(), float(want), **LOSS_TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(want_g), **LOSS_TOL)


@pytest.mark.parametrize("code", [
    "pragma solidity ^0.8.0;\ncontract A { function f() public {} }",
    "contract A {}",
    "pragma solidity ^0.8.0;\ncontract A { function f() public { }",
    "pragma solidity 0.4.24;\ncontract B { uint x; ) (",
    "pragma solidity >=0.8;\ncontract C {}",
    "",
])
def test_syntax_check_and_jaccard_match_jax(code):
    assert SolidityCodeLoss.check_solidity_syntax(code) == \
        JaxSolidityCodeLoss.check_solidity_syntax(code)
    other = "pragma solidity ^0.8.0; contract A { uint public total; }"
    for a, b in ((code, other), (other, code), (code, code)):
        assert SolidityCodeLoss.compute_semantic_similarity(a, b) == \
            JaxSolidityCodeLoss.compute_semantic_similarity(a, b)
