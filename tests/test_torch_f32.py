"""The port's f32 attention paths against the JAX package's, on the CPU.

The JAX kernels compute in their operands' dtype, so f32 operands give f32
attention there: CodeBERT in the TASC trainer (no dtype, so f32), the TASC
decode caches (f32 whatever the compute dtype) and
``ModelConfig(compute_dtype="float32")``. The port runs the same on the
card through its f32 kernels; on the CPU each wrapper runs its plain
version, which these tests hold to the JAX package on numpy-seeded inputs:

  * the flash attention at f32 with a key mask, causal, dropout and the
    LSE: the forward within 1e-5 and the gradients within 1e-4, norm-wise
    (||got - want|| / ||want||: the same f32 math summed in another
    order; the gradients go through one more softmax);
  * the decode attention with a bf16 query and f32 caches: the output in
    the query's dtype on both sides, within one bf16 step (each side
    rounds an f32 result that agrees to ~1e-6 once);
  * the TASC trainer's CodeBERT computes in f32 whatever the TASC compute
    dtype, and two layers of it match ``FlaxCodeBERT`` within 1e-5;
  * the TASC decoder's caches are f32, and tokens sampled from the same
    Gumbel noise over its logits equal JAX's, step for step;
  * ``entry.tiny_config`` computes in f32 on the card as on the CPU;
  * the f32 routes: 16 -> 64, 80 -> 96, 128 in place, over 128 raises.

Kept small: one thread of torch, head dims of the f32 instances, short
sequences.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from sct_gan_tpu.ops.attention import mha_reference as jax_mha
from sct_gan_tpu.ops.flash_attention import _flash_forward as jax_flash_forward
from sct_gan_tpu.variants import tasc as jtasc
from sct_gan_tpu_torch.config import CodeBERTConfig, TASCConfig
from sct_gan_tpu_torch.convert import convert_flax_params
from sct_gan_tpu_torch.entry import tiny_config
from sct_gan_tpu_torch.ops import decode_attention as k5
from sct_gan_tpu_torch.ops import flash_attention as k1
from sct_gan_tpu_torch.data.tokenizer import SolidityTokenizer
from sct_gan_tpu_torch.variants import (SmartContractVulnerabilityGAN,
                                        VulnerabilityDetectionTrainer)
from test_torch_codebert import _jax_model
from test_torch_ops import _jax_seed
from test_torch_tasc import (TINY, jax_config, numpy_tree, port_model,
                             tasc_flax_params)

FWD_TOL = 1e-5
GRAD_TOL = 1e-4


class _Empty:
    """A loader with no batches: the trainer is built, never trained."""
    batch_size = 2

    def __iter__(self):
        return iter(())


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("causal", [False, True], ids=["key_mask", "causal"])
def test_f32_flash_matches_jax(causal):
    """f32 at head dim 64 (B=2, H=2, S=96; row 0 with a masked tail, row
    1 attending its first 40 keys), dropout 0.3: the port's output and
    dq, dk, dv against JAX's ``mha_reference`` with its own dropout seed
    (the same hash mask) and ``jax.vjp``; the LSE against JAX's flash
    forward in interpret mode."""
    rng = np.random.default_rng(21)
    b, h, s, d = 2, 2, 96, 64
    q, k, v, g = (rng.normal(size=(b, h, s, d)).astype(np.float32)
                  for _ in range(4))
    mask = np.arange(s)[None, :] < np.asarray([s - 9, 40])[:, None]
    key, rate, scale = jax.random.PRNGKey(5), 0.3, d ** -0.5

    def jax_fwd(q_, k_, v_):
        return jax_mha(q_, k_, v_, key_padding_mask=jnp.asarray(mask),
                       causal=causal, dropout_rate=rate, deterministic=False,
                       dropout_rng=key, sm_scale=scale)
    want, vjp = jax.vjp(jax_fwd, *map(jnp.asarray, (q, k, v)))
    want_g = vjp(jnp.asarray(g))
    bias = jnp.where(jnp.asarray(mask), 0.0, -1e30).astype(jnp.float32)
    with pltpu.force_tpu_interpret_mode():
        _, want_lse, _ = jax_flash_forward(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bias,
            jnp.int32(0), causal, s, 64, 0.0, scale, True)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got, lse = k1.flash_attention(
        tq, tk, tv, key_padding_mask=torch.from_numpy(mask), causal=causal,
        sm_scale=scale, dropout_rate=rate, seed=_jax_seed(key),
        return_lse=True)
    got_g = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(g))
    assert got.dtype == torch.float32 and lse.dtype == torch.float32
    assert rel(got.detach(), want) <= FWD_TOL
    assert rel(lse.detach(), np.asarray(want_lse)[:, :, :s, 0]) <= FWD_TOL
    for name, a, w in zip(("dq", "dk", "dv"), got_g, want_g):
        assert rel(a, w) <= GRAD_TOL, name


def test_decode_bf16_query_f32_caches_matches_jax():
    """The TASC self-attention step's operands: a bf16 query against f32
    caches cut to pos + 1 keys. JAX's decode reference (``mha_reference``
    at Sq = 1, what its decode step runs off the TPU) in f32, rounded to
    the query's dtype as its kernel's output is (decode_attention.py:74),
    against the port's, dtype included."""
    rng = np.random.default_rng(3)
    b, h, s, d, pos = 2, 4, 40, 64, 29
    q = rng.normal(size=(b, h, 1, d)).astype(np.float32)
    kc, vc = (rng.normal(size=(b, h, s, d)).astype(np.float32)
              for _ in range(2))
    qb = jnp.asarray(q).astype(jnp.bfloat16)
    visible = np.broadcast_to(np.arange(s)[None, :] <= pos, (b, s))
    want = jax_mha(qb, jnp.asarray(kc), jnp.asarray(vc),
                   key_padding_mask=jnp.asarray(visible),
                   sm_scale=d ** -0.5).astype(qb.dtype)
    tq = torch.from_numpy(q).to(torch.bfloat16)
    tk, tv = torch.from_numpy(kc), torch.from_numpy(vc)
    got = k5.decode_attention(tq, tk[:, :, :pos + 1], tv[:, :, :pos + 1],
                              None, sm_scale=d ** -0.5)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2.0 ** -8, atol=1e-6)


def test_tasc_codebert_is_f32_and_matches_jax():
    """``CodeBERTConfig.from_tasc`` computes in f32 for a bf16 TASC config
    too (the JAX trainer's ``FlaxCodeBERT`` has no dtype), and the
    embedder of a bf16 TASC trainer, two layers deep, matches the JAX one
    within 1e-5, padded tails included."""
    assert CodeBERTConfig.from_tasc(TASCConfig()).compute_dtype == "float32"
    cfg = dataclasses.replace(TINY, compute_dtype="bfloat16",
                              codebert_num_layers=2)
    cb = CodeBERTConfig.from_tasc(cfg)
    assert cb.compute_dtype == "float32" and cb.num_layers == 2
    ids0 = jnp.zeros((1, 8), jnp.int32)
    params = numpy_tree(jax.eval_shape(lambda key: _jax_model(cb).init(
        {"params": key}, ids0, jnp.ones_like(ids0))["params"],
        jax.random.PRNGKey(0)), seed=6)
    rng = np.random.default_rng(1)
    lengths = np.asarray([24, 13, 4])
    mask = (np.arange(24)[None, :] < lengths[:, None]).astype(np.int32)
    ids = np.where(mask, rng.integers(3, cb.vocab_size, (3, 24)),
                   0).astype(np.int32)
    want = _jax_model(cb).apply({"params": params}, jnp.asarray(ids),
                                jnp.asarray(mask))
    trainer = VulnerabilityDetectionTrainer(
        SmartContractVulnerabilityGAN(cfg), _Empty(), _Empty(),
        tokenizer=SolidityTokenizer(vocab_size=cfg.vocab_size),
        codebert_params=convert_flax_params(params, cb), verbose=False,
        device="cpu")
    got = trainer._embed(ids, mask)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_tasc_caches_are_f32_and_sampled_tokens_match_jax():
    """A bf16 TASC decoder (the default compute dtype) keeps f32 caches on
    both sides; 6 KV-cached steps against a one-key memory, each side
    sampling argmax(logits + the same numpy Gumbel noise) from its own
    logits and feeding its token back, give the same tokens."""
    cfg = dataclasses.replace(TINY, compute_dtype="bfloat16")
    params = tasc_flax_params(cfg, seed=3)
    jm = jtasc.SmartContractVulnerabilityGAN(jax_config(cfg))
    tm = port_model(cfg, params)
    rng = np.random.default_rng(4)
    memory = rng.normal(0, 1, (2, 1, cfg.d_model)).astype(np.float32)
    noise = rng.gumbel(size=(6, 2, cfg.decoder_vocab_size)).astype(np.float32)
    apply = lambda fn, *a: jm.apply({"params": params}, *a, method=fn)
    cross = apply(lambda m, mem: m.decoder.cross_kvs(mem),
                  jnp.asarray(memory))
    caches = apply(lambda m, b: m.decoder.init_cache(b), 2)
    with torch.no_grad():
        tcross = tm.decoder.cross_kvs(torch.from_numpy(memory))
        tcaches = tm.decoder.init_cache(2)
        assert all(c.dtype == torch.float32 for kv in tcaches for c in kv)
        assert all(c.dtype == jnp.float32 for kv in caches for c in kv)
        jt = tt = np.full((2, 1), 1, np.int32)       # the pragma seed
        jtoks, ttoks = [], []
        for pos in range(6):
            jl, caches = apply(lambda m, *a: m.decoder.decode_step(*a),
                               jnp.asarray(jt), pos, caches, cross)
            tl = tm.decoder.decode_step(torch.from_numpy(tt).long(), pos,
                                        tcaches, tcross)
            jt = np.argmax(np.asarray(jl, np.float32) + noise[pos],
                           -1)[:, None].astype(np.int32)
            tt = np.argmax(tl.float().numpy() + noise[pos],
                           -1)[:, None].astype(np.int32)
            jtoks.append(jt[:, 0])
            ttoks.append(tt[:, 0])
    assert np.array_equal(np.stack(ttoks), np.stack(jtoks))
    assert all(c.dtype == torch.float32 for kv in tcaches for c in kv)


def test_tiny_config_is_f32_on_every_device():
    """The root file's dry-run model computes in f32 (its own dtype) on the
    card too: the f32 flash kernels take it there."""
    assert tiny_config("cuda").compute_dtype == "float32"
    assert tiny_config("cpu").compute_dtype == "float32"


def test_f32_routes():
    """The f32 route (the flash kernels' and K5's): the smallest instance
    that holds the head dim (16 -> 64, 80 -> 96), the instances in place,
    and over 128 a raise naming the head dim and the dtype. The bf16
    routes stay as they were."""
    assert k1.kernel_route_f32(16) == 64
    assert k1.kernel_route_f32(80) == 96
    assert [k1.kernel_route_f32(d) for d in (64, 96, 128)] == [64, 96, 128]
    assert k1.kernel_head_dim(16, torch.float32) == 64
    assert k1.runs_on_kernel(96, torch.float32)
    assert not k1.runs_on_kernel(80, torch.float32)
    assert not k1.runs_on_kernel(192, torch.float32)
    with pytest.raises(ValueError, match="head dim 192 in float32"):
        k1.kernel_route_f32(192)
    assert k1.kernel_head_dim(80) == 96 and k1.kernel_head_dim(384) == 384


def test_f32_wrapper_layout_checks():
    """What the f32 kernels read, checked on any device: f32 rows of whole
    16-byte units (4 elements); mixed q/k/v dtypes refused."""
    x = torch.zeros(2, 64, 8 * 96)                  # (B, S, H * 96) f32
    q = x.view(2, 64, 8, 96).transpose(1, 2)
    assert k1.head_strides(q, "q", 16) == (64 * 768, 96, 768)
    with pytest.raises(ValueError, match="16-byte"):
        k1.head_strides(torch.zeros(2, 2, 8, 66)[..., :64], "q", 16)
    with pytest.raises(ValueError, match="dtypes"):
        k1._check_dtypes(q, q.to(torch.bfloat16), q)
    with pytest.raises(ValueError, match="dtypes"):
        k1._check_dtypes(q.double(), q.double(), q.double())
