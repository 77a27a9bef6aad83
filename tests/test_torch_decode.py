"""The split-K decode attention's arithmetic and choices, on the CPU.

``decode_attention_split_reference`` repeats in plain PyTorch what the
kernel (``csrc/decode_attention.cu``) does: each split walks its 64-key
tiles with an online softmax, then the splits are combined in order. Here
it is held against the JAX package's ``decode_attention`` in interpret mode
on the same numpy inputs, at the edges of the design: tolerance 1e-5 (rtol
and atol) in f32, the same math summed in another order. The split count
and the split ranges are plain functions of the shapes; the wrapper's
checks read only shapes and strides, so ``meta`` tensors stand in for the
card. The kernel itself is held against the plain version on a card in
``test_torch_kernels.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sct_gan_tpu.ops.decode_attention import \
    decode_attention as jax_decode_attention
from sct_gan_tpu_torch.ops.decode_attention import (
    CARD_SMS, MAX_SPLITS, TILE_KEYS, decode_attention_reference,
    decode_attention_split_reference, decode_head_dim, decode_layout,
    decode_route, decode_runs_on_kernel, decode_splits, split_ranges)

TOL = dict(rtol=1e-5, atol=1e-5)

SPLIT_CASES = {
    # name: (splits, S, mask kind)
    "splits1_s200": (1, 200, "random"),
    "splits2_s130": (2, 130, "random"),
    "splits3_s200": (3, 200, "random"),
    "splits8_s517": (8, 517, "random"),
    # row 0 attends keys < 50 only: splits 1 and 2 see no attended key
    "split_all_masked": (3, 200, "head"),
    "fully_masked_row": (2, 130, "row_empty"),
    "s1": (1, 1, None),
    # past the old kernel's 8192-key limit, 129 tiles over 8 splits
    "splits8_s8200": (8, 8200, None),
}


@pytest.mark.parametrize("case", sorted(SPLIT_CASES))
def test_split_oracle_matches_jax_kernel(case):
    splits, s, kind = SPLIT_CASES[case]
    rng = np.random.default_rng(7)
    b, h, d = 2, 2, 32
    q = rng.normal(size=(b, h, 1, d)).astype(np.float32)
    k = rng.normal(size=(b, h, s, d)).astype(np.float32)
    v = rng.normal(size=(b, h, s, d)).astype(np.float32)
    mask = rng.random((b, s)) < 0.6
    if kind is None:
        mask[:] = True
    elif kind == "head":
        mask[0] = np.arange(s) < 50
    elif kind == "row_empty":
        mask[1] = False
    scale = 1.0 / 96 ** 0.5
    tmask = None if kind is None else torch.from_numpy(mask)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = decode_attention_split_reference(tq, tk, tv, tmask, sm_scale=scale,
                                           splits=splits).numpy()
    want = jax_decode_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(mask),
                                sm_scale=scale, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    plain = decode_attention_reference(tq, tk, tv, tmask, sm_scale=scale)
    np.testing.assert_allclose(got, plain.numpy(), **TOL)
    if kind == "row_empty":
        assert np.all(got[1] == 0.0)


@pytest.mark.parametrize("b,h,s,want", [
    (2, 8, 1024, 8),      # generation at B=2: 128 blocks of 128 keys
    (64, 8, 1024, 1),     # the JAX bench's decode batch: 512 blocks
    (1, 8, 1, 1),         # the first decode step: one key
    (2, 8, 100, 2),       # fewer tiles than the wave asks for
    (3, 8, 65, 2),
    (8, 8, 1024, 3),
    (16, 8, 1024, 2),
    (17, 8, 4096, 1),     # B * H = 136 fills the wave alone
    (32, 8, 1024, 1),     # the K9 tool's batch
    (2, 8, 16384, 8),
])
def test_decode_splits_fill_a_wave_without_empty_splits(b, h, s, want):
    splits = decode_splits(b, h, s)
    assert splits == want
    tiles = -(-s // TILE_KEYS)
    assert 1 <= splits <= min(MAX_SPLITS, tiles)
    # one wave where S and the cluster allow, and no more splits than that
    assert b * h * splits >= CARD_SMS or splits == min(MAX_SPLITS, tiles)
    assert splits == 1 or b * h * (splits - 1) < CARD_SMS
    ranges = split_ranges(s, splits)
    assert ranges[0][0] == 0 and ranges[-1][1] == s
    for (lo, hi), (nlo, _) in zip(ranges, ranges[1:] + [(s, s)]):
        assert lo < hi == nlo and lo % TILE_KEYS == 0


@pytest.mark.parametrize("d", [160, 192, 224, 256])
@pytest.mark.parametrize("splits", [1, 3, 8])
def test_split_oracle_matches_jax_kernel_at_wide_instances(d, splits):
    """The split-and-combine arithmetic at the 192 instance, at 160 (in
    place on it) and at the wide-head route's 224 and 256, against the JAX
    kernel in interpret mode, under a mask with a fully masked row."""
    rng = np.random.default_rng(d + splits)
    b, h = 2, 2
    s = 8 * TILE_KEYS + 5 if splits == 8 else 3 * TILE_KEYS + 8
    q = rng.normal(size=(b, h, 1, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, h, s, d)).astype(np.float32)
            for _ in range(2))
    mask = rng.random((b, s)) < 0.6
    mask[1] = False
    scale = d ** -0.5
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = decode_attention_split_reference(tq, tk, tv, torch.from_numpy(mask),
                                           sm_scale=scale, splits=splits)
    want = jax_decode_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(mask),
                                sm_scale=scale, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert np.all(got.numpy()[1] == 0.0)


@pytest.mark.parametrize("b,h,s,d,want", [
    (2, 4, 1024, 192, 8),     # ModelConfig(nhead=4)'s generation: 64 blocks
    (8, 4, 1024, 192, 5),     # 160 blocks
    (16, 4, 1024, 160, 3),
    (5, 4, 1024, 224, 4),     # two chunks: 40 (b, chunk, h), 160 blocks
    (33, 4, 1024, 192, 1),    # B * H = 132
    (64, 4, 1024, 192, 1),    # the decode batch: 256 blocks, 2 waves
    (2, 3, 1024, 256, 8),     # two chunks: 12 (b, chunk, h)
    (64, 3, 1024, 256, 1),
    (2, 4, 100, 192, 2),      # fewer tiles than the wave allows
])
def test_decode_splits_at_the_wide_head_dims(b, h, s, d, want):
    """The split count the wrapper asks for over 128, where the 192
    instance fits one block an SM and the wide-head route runs a cluster
    per (b, chunk, h): the same rule as every head dim, the least count
    that fills a wave of 132 blocks, never an empty split."""
    rows = b * decode_route(d)[1]
    splits = decode_splits(rows, h, s)
    assert splits == want
    tiles = -(-s // TILE_KEYS)
    assert 1 <= splits <= min(MAX_SPLITS, tiles)
    assert rows * h * splits >= CARD_SMS or splits == min(MAX_SPLITS, tiles)
    assert splits == 1 or rows * h * (splits - 1) < CARD_SMS


@pytest.mark.parametrize("d,route,in_place", [
    (64, (64, 1), True),
    (80, (96, 1), True),              # in place on the 96 instance
    (96, (96, 1), True),
    (100, (128, 1), False),           # 200-byte rows: a copy padded to 128
    (128, (128, 1), True),
    (160, (192, 1), True),
    (192, (192, 1), True),
    (224, (128, 2), True),            # the wide route, in place
    (256, (128, 2), True),
    (300, (128, 3), False),           # 600-byte rows: a copy padded to 384
    (320, (128, 3), True),
    (384, (128, 3), True),
    (512, (128, 4), True),
])
def test_decode_route(d, route, in_place):
    """The instance and chunks a head dim runs as, and whether the kernel
    takes it with no copy; the copy, where there is one, is padded to the
    route's head dim, which the kernel takes."""
    assert decode_route(d) == route
    assert decode_head_dim(d) == route[0] * route[1]
    assert decode_runs_on_kernel(d) == in_place
    assert decode_runs_on_kernel(decode_head_dim(d))


def _meta(b, h, s, d=96, row=None):
    """A (b, h, s, d) bf16 meta tensor, contiguous, or with ``row``
    elements between rows."""
    if row is None:
        return torch.empty(b, h, s, d, dtype=torch.bfloat16, device="meta")
    return torch.empty_strided((b, h, s, d), (h * s * row, s * row, row, 1),
                               dtype=torch.bfloat16, device="meta")


@pytest.mark.parametrize("s", [1, 8192, 8193, 16384, 100_000])
def test_decode_layout_takes_any_key_count(s):
    """The wrapper's checks before the launch: no key limit, contiguous
    caches and the cross K/V's head views of (B, S, 768) alike."""
    q = _meta(2, 8, 1)
    cross = torch.empty(2, s, 768, dtype=torch.bfloat16,
                        device="meta").view(2, s, 8, 96).transpose(1, 2)
    assert decode_layout(q, _meta(2, 8, s), _meta(2, 8, s))[1] == (
        8 * s * 96, s * 96, 96)
    assert decode_layout(q, cross, cross)[2] == (s * 768, 96, 768)


@pytest.mark.parametrize("case", ["no_keys", "head_dim_64", "head_dim_100",
                                  "two_queries", "rows_off_16_bytes"])
def test_decode_layout_refuses_what_the_kernel_cannot_take(case):
    q, k = _meta(2, 8, 1), _meta(2, 8, 100)
    if case == "no_keys":
        k = _meta(2, 8, 0)
    elif case == "head_dim_64":      # q's head dim 64 against k's 96
        q = _meta(2, 8, 1, 64)
    elif case == "head_dim_100":     # not whole 16-byte units: the wrapper
        q, k = _meta(2, 8, 1, 100), _meta(2, 8, 100, 100)    # pads it
    elif case == "two_queries":
        q = _meta(2, 8, 2)
    else:                      # 200-byte rows: not whole 16-byte units
        k = _meta(2, 8, 100, row=100)
    with pytest.raises(ValueError):
        decode_layout(q, k, k)
