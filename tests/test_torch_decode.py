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
    decode_attention_split_reference, decode_layout, decode_splits,
    split_ranges)

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


@pytest.mark.parametrize("case", ["no_keys", "head_dim_64", "head_dim_80",
                                  "two_queries", "rows_off_16_bytes"])
def test_decode_layout_refuses_what_the_kernel_cannot_take(case):
    q, k = _meta(2, 8, 1), _meta(2, 8, 100)
    if case == "no_keys":
        k = _meta(2, 8, 0)
    elif case == "head_dim_64":      # q's head dim 64 against k's 96
        q = _meta(2, 8, 1, 64)
    elif case == "head_dim_80":      # no instance: the wrapper pads it
        q, k = _meta(2, 8, 1, 80), _meta(2, 8, 100, 80)
    elif case == "two_queries":
        q = _meta(2, 8, 2)
    else:                      # 200-byte rows: not whole 16-byte units
        k = _meta(2, 8, 100, row=100)
    with pytest.raises(ValueError):
        decode_layout(q, k, k)
