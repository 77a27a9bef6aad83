"""The f32-cache decode attention's route, splits and arithmetic, on the CPU.

``csrc/decode_attention_f32.cu`` (K5 over f32 caches) runs any head dim
that is a multiple of 4 in place, in tiles of 64, 32, 16 or 8 keys as the
head dim grows (past 1024 on its column-chunk route, which keeps the 8-key
tiles), each of a block's 8 warps keeping its own online softmax over its
keys of every tile, the warps and then the splits combined in order.
``decode_attention_f32_split_reference`` repeats that arithmetic in plain
PyTorch; here it is held against the JAX package's ``decode_attention`` in
interpret mode on the same numpy inputs at head dims 48, 80, 192, 384, 768
and 1280 and at 1 to 16 splits, and the plain version at (1, 1, 16, 768)
and (1, 1, 16, 1280): tolerance 1e-5 (rtol and atol) in f32, the same math
summed in another order. The route, the split
count and the wrapper's checks are plain functions of the shapes (``meta``
tensors stand in for the card). The TASC decoder at head dim 192 decodes
the same tokens as JAX's from the same Gumbel noise, as it does at 96 in
``test_torch_f32.py``. The kernel itself is held against the plain version
on a card in ``test_torch_kernels_f32.py``.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sct_gan_tpu.ops.decode_attention import \
    decode_attention as jax_decode_attention
from sct_gan_tpu.variants import tasc as jtasc
from sct_gan_tpu_torch.ops.decode_attention import (
    CARD_SMS, F32_WIDE_CHUNK, MAX_SPLITS, MAX_SPLITS_F32,
    decode_attention_f32_split_reference, decode_attention_reference,
    decode_chunks_f32, decode_layout, decode_route_f32, decode_splits_f32,
    decode_tile_keys_f32, split_ranges)
from sct_gan_tpu_torch.ops.flash_attention import kernel_route_f32
from test_torch_tasc import TINY, jax_config, port_model, tasc_flax_params

TOL = dict(rtol=1e-5, atol=1e-5)
ORACLE_HEAD_DIMS = (48, 80, 192, 384, 768, 1280)


@pytest.mark.parametrize("d,route", [
    (16, 16), (48, 48), (64, 64), (80, 80), (96, 96), (128, 128),
    (132, 132), (192, 192), (256, 256), (384, 384), (512, 512),
    (30, 32),              # 120-byte rows: a copy padded to 32
    (516, 516), (768, 768), (1024, 1024), (1028, 1028), (1280, 1280),
    (1030, 1032),
])
def test_decode_route_f32(d, route):
    """Every multiple of 4 runs as it is; any other head dim on a copy
    padded to the next multiple of 4. The f32 flash kernels route on their
    own: over 128 in 64-column chunks of the next multiple of 64."""
    assert decode_route_f32(d) == route
    assert decode_route_f32(route) == route
    if d > 128:
        assert kernel_route_f32(d) == (64, -(-d // 64))


def test_decode_route_f32_raises_over_512():
    """No head dim raises any more, as in the JAX kernel: an instance holds
    the whole row up to 1024, the column-chunk route takes 1024-column
    chunks of o above."""
    for d in (516, 768, 1024, 1028, 2048, 4100):
        assert decode_route_f32(d) == d
        assert decode_chunks_f32(d) == (1 if d <= 1024 else -(-d // 1024))
    assert F32_WIDE_CHUNK == 1024


@pytest.mark.parametrize("d,tile", [(16, 64), (96, 64), (128, 64),
                                    (132, 32), (192, 32), (196, 16),
                                    (384, 16), (512, 16), (516, 8),
                                    (768, 8), (1024, 8), (1280, 8)])
def test_decode_tile_keys_f32(d, tile):
    """Tiles shrink as the head dim grows: a stage of K and V rows stays at
    most 64 KB, and at most 48 KB (two blocks an SM) from 132 to 384 and
    from 516 to 768; past 1024 the column-chunk route keeps the 8-key
    tiles and has no ring."""
    assert decode_tile_keys_f32(d) == tile
    two_blocks = 128 < d <= 384 or 512 < d <= 768
    if d <= F32_WIDE_CHUNK:
        assert 2 * tile * d * 4 <= (48 if two_blocks else 64) * 1024


@pytest.mark.parametrize("b,h,s,d,want", [
    (2, 8, 1024, 96, 8),      # generation at B=2: 128 blocks
    (2, 8, 513, 96, 8),       # TASC's self attention, the cache cut to 513
    (2, 8, 100, 96, 2),       # fewer tiles than the card has room for
    (2, 8, 300, 96, 4),       # 5 tiles: a power of two below
    (2, 12, 1024, 64, 8),     # 192 blocks, two an SM
    (2, 4, 1024, 192, 8),     # TASC nhead=4: 8 (b, h), 32-key tiles
    (2, 3, 1024, 256, 16),    # 64 16-key tiles: 8 splits would walk 8 each
    (2, 2, 1024, 384, 16),
    (2, 2, 100, 384, 4),      # 16-key tiles: 7 of them
    (16, 8, 1024, 96, 2),     # 128 (b, h): 256 blocks
    (64, 8, 1024, 96, 1),     # the JAX bench's decode batch
    (1, 8, 1, 96, 1),         # the first decode step: one key
    (2, 1, 1024, 768, 16),    # nhead=1 at d=768: 128 8-key tiles
    (64, 1, 1024, 768, 4),    # the decode batch at nhead=1
    (2, 1, 1024, 1024, 16),
    (4, 1, 1024, 1280, 16),   # past 1024: B=2 in 2 column chunks
    (2, 1, 20, 768, 2),       # 3 tiles
])
def test_decode_splits_f32(b, h, s, d, want):
    """The f32 kernel's split count: a power of two, at most 8 (one
    portable cluster) unless that leaves a split more than 4 tiles, within
    two blocks an SM of 132 and never an empty split."""
    splits = decode_splits_f32(b, h, s, d)
    assert splits == want
    tiles = -(-s // decode_tile_keys_f32(d))
    assert 1 <= splits <= min(MAX_SPLITS_F32, tiles)
    assert splits <= MAX_SPLITS or tiles > 4 * MAX_SPLITS
    assert splits & (splits - 1) == 0
    assert b * h * splits <= 2 * CARD_SMS or splits == 1
    ranges = split_ranges(s, splits, decode_tile_keys_f32(d))
    assert ranges[0][0] == 0 and ranges[-1][1] == s
    for (lo, hi), (nlo, _) in zip(ranges, ranges[1:] + [(s, s)]):
        assert lo < hi == nlo


@functools.lru_cache(maxsize=None)
def _oracle_case(d):
    """Numpy inputs at head dim ``d`` with 16 tiles and 5 keys, a mask with
    a fully masked row and a dead tail, and the JAX kernel's output."""
    rng = np.random.default_rng(d)
    b, h = 2, 2
    s = 16 * decode_tile_keys_f32(d) + 5
    q = rng.normal(size=(b, h, 1, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, h, s, d)).astype(np.float32)
            for _ in range(2))
    mask = rng.random((b, s)) < 0.6
    mask[0, s // 2:] = False
    mask[1] = False
    want = np.asarray(jax_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        sm_scale=d ** -0.5, interpret=True))
    return q, k, v, mask, want


@pytest.mark.parametrize("splits", range(1, MAX_SPLITS_F32 + 1))
@pytest.mark.parametrize("d", ORACLE_HEAD_DIMS)
def test_f32_split_oracle_matches_jax_kernel(d, splits):
    """The f32 kernel's split, warp and combine arithmetic against the JAX
    kernel in interpret mode, within 1e-5: splits whose keys are all
    masked, a fully masked row (zeros) and keys past a tile's end
    included."""
    q, k, v, mask, want = _oracle_case(d)
    tq, tk, tv, tm = map(torch.from_numpy, (q, k, v, mask))
    got = decode_attention_f32_split_reference(
        tq, tk, tv, tm, sm_scale=d ** -0.5, splits=splits).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.all(got[1] == 0.0)
    plain = decode_attention_reference(tq, tk, tv, tm, sm_scale=d ** -0.5)
    np.testing.assert_allclose(got, plain.numpy(), **TOL)


@pytest.mark.parametrize("d", [768, 1280])
def test_f32_plain_matches_jax_kernel_past_512(d):
    """The plain K5 f32 at (1, 1, 16, d) under a mask with a hole, against
    the JAX kernel in interpret mode, within 1e-5."""
    rng = np.random.default_rng(d + 1)
    q = rng.normal(size=(1, 1, 1, d)).astype(np.float32)
    k, v = (rng.normal(size=(1, 1, 16, d)).astype(np.float32)
            for _ in range(2))
    mask = np.ones((1, 16), bool)
    mask[0, 5:9] = False
    want = np.asarray(jax_decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        sm_scale=d ** -0.5, interpret=True))
    got = decode_attention_reference(*map(torch.from_numpy, (q, k, v, mask)),
                                     sm_scale=d ** -0.5)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_f32_split_oracle_keeps_a_bf16_query():
    """A bf16 query over f32 caches: the oracle's output is bf16, within
    one bf16 step of the plain version's."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 3, 1, 132, generator=g).to(torch.bfloat16)
    k, v = (torch.randn(2, 3, 70, 132, generator=g) for _ in range(2))
    got = decode_attention_f32_split_reference(q, k, v, sm_scale=0.1,
                                               splits=3)
    want = decode_attention_reference(q, k, v, sm_scale=0.1)
    assert got.dtype == want.dtype == torch.bfloat16
    assert (got.float() - want.float()).abs().max().item() <= 2 ** -7


def _meta(b, h, s, d, dtype=torch.float32, row=None):
    """A (b, h, s, d) meta tensor, contiguous or ``row`` elements apart."""
    if row is None:
        return torch.empty(b, h, s, d, dtype=dtype, device="meta")
    return torch.empty_strided((b, h, s, d), (h * s * row, s * row, row, 1),
                               dtype=dtype, device="meta")


@pytest.mark.parametrize("d", [16, 48, 132, 192, 384, 512, 516, 768, 1024,
                               1284])
def test_decode_layout_f32_takes_multiples_of_4(d):
    """The f32 kernel's checks before the launch: head dims that are
    multiples of 4, a bf16 or f32 query, caches cut to fewer
    keys (a strided view) and head views of (B, S, H * d)."""
    for qdt in (torch.float32, torch.bfloat16):
        q = _meta(2, 4, 1, d, qdt)
        cache = _meta(2, 4, 1024, d)[:, :, :300]
        cross = torch.empty(2, 300, 4 * d, device="meta").view(
            2, 300, 4, d).transpose(1, 2)
        assert decode_layout(q, cache, cache, f32=True)[1] == (
            4 * 1024 * d, 1024 * d, d)
        assert decode_layout(q, cross, cross, f32=True)[2] == (
            300 * 4 * d, d, 4 * d)


@pytest.mark.parametrize("case", ["head_dim_30", "head_dim_516",
                                  "rows_off_16_bytes"])
def test_decode_layout_f32_refuses_what_the_kernel_cannot_take(case):
    q, k = _meta(2, 4, 1, 96), _meta(2, 4, 100, 96)
    if case == "head_dim_30":       # rows of part 16-byte units: padded
        q, k = _meta(2, 4, 1, 30), _meta(2, 4, 100, 30)
    elif case == "head_dim_516":    # taken in place, but not on rows
        q = _meta(2, 4, 1, 516)     # 2068 bytes apart
        k = _meta(2, 4, 100, 516, row=517)
    else:                           # 392-byte rows
        k = _meta(2, 4, 100, 96, row=98)
    with pytest.raises(ValueError):
        decode_layout(q, k, k, f32=True)


def test_tasc_head_dim_192_sampled_tokens_match_jax():
    """TASC at head dim 192 (d_model 384, nhead 2, one layer, f32 caches
    on both sides): 6 KV-cached steps against a one-key memory, each side
    sampling argmax(logits + the same numpy Gumbel noise) from its own
    logits and feeding its token back, give the same tokens, and each
    step's logits agree within 1e-5. The decoder computes in f32: in bf16
    the two frameworks round the logits a bf16 step apart (~2e-2 at
    |logit| ~2, at head dim 16 as at 192), enough to flip a near tie."""
    cfg = dataclasses.replace(TINY, d_model=384, nhead=2,
                              compute_dtype="float32")
    params = tasc_flax_params(cfg, seed=5)
    jm = jtasc.SmartContractVulnerabilityGAN(jax_config(cfg))
    tm = port_model(cfg, params)
    rng = np.random.default_rng(6)
    memory = rng.normal(0, 1, (2, 1, cfg.d_model)).astype(np.float32)
    noise = rng.gumbel(size=(6, 2, cfg.decoder_vocab_size)).astype(np.float32)
    apply = lambda fn, *a: jm.apply({"params": params}, *a, method=fn)
    cross = apply(lambda m, mem: m.decoder.cross_kvs(mem),
                  jnp.asarray(memory))
    caches = apply(lambda m, b: m.decoder.init_cache(b), 2)
    with torch.no_grad():
        tcross = tm.decoder.cross_kvs(torch.from_numpy(memory))
        tcaches = tm.decoder.init_cache(2)
        assert all(c.dtype == torch.float32 and c.shape[-1] == 192
                   for kv in tcaches for c in kv)
        jt = tt = np.full((2, 1), 1, np.int32)       # the pragma seed
        jtoks, ttoks = [], []
        for pos in range(6):
            jl, caches = apply(lambda m, *a: m.decoder.decode_step(*a),
                               jnp.asarray(jt), pos, caches, cross)
            tl = tm.decoder.decode_step(torch.from_numpy(tt).long(), pos,
                                        tcaches, tcross)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
            jt = np.argmax(np.asarray(jl, np.float32) + noise[pos],
                           -1)[:, None].astype(np.int32)
            tt = np.argmax(tl.float().numpy() + noise[pos],
                           -1)[:, None].astype(np.int32)
            jtoks.append(jt[:, 0])
            ttoks.append(tt[:, 0])
    assert np.array_equal(np.stack(ttoks), np.stack(jtoks))
