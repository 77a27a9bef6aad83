"""The port's CUDA kernels against their plain versions, on a CUDA card.

Marked ``cuda``; without a card each test skips. This file imports no JAX,
so it runs on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(``chip_smoke.py`` checks the same kernels at the main path's full shapes,
and the kernel-timing tools' kernels, K7-K10, at the tools' shapes.)
"""
import math

import pytest
import torch

from sct_gan_tpu_torch.ops.decode_attention import (
    decode_attention, decode_attention_reference)
from sct_gan_tpu_torch.ops.dropout import dropout, dropout_reference
from sct_gan_tpu_torch.ops.flash_attention import (
    _forward, flash_attention, flash_attention_backward,
    flash_attention_reference)
from sct_gan_tpu_torch.tools import time_decode_kernel_variants as k9
from sct_gan_tpu_torch.tools import time_dropout_kernel as k10
from sct_gan_tpu_torch.tools import time_flash_parts as k7
from sct_gan_tpu_torch.tools import time_flash_variants as k8
from sct_gan_tpu_torch.utils import profiling

FLASH_CASES = {
    # name: (sq, sk, causal, mask kind, (B, H, layout)); layout "bhsd" is a
    # contiguous (B, H, S, 96) tensor, "heads" the model's (B, H, S, 96)
    # view of its (B, S, H*96) projections
    "key_mask": (128, 128, False, "tail", (2, 8, "bhsd")),
    "causal": (128, 128, True, None, (2, 8, "bhsd")),
    "sq_ne_sk": (64, 160, False, "tail", (2, 8, "bhsd")),
    "ragged": (100, 100, True, "tail", (2, 8, "bhsd")),
    "fully_masked_row": (64, 96, False, "one_row_empty", (2, 8, "bhsd")),
    # the edges of the kernels' tiles: 128 query rows a forward block, 64
    # keys a forward tile, 128 keys (dKV) or queries (dQ) a backward block
    "sq200_sk1000": (200, 1000, False, "tail", (2, 8, "bhsd")),
    "causal_1000": (1000, 1000, True, None, (2, 8, "bhsd")),
    "head_view_1024": (1024, 1024, False, "tail", (2, 8, "heads")),
    "b4_h8_2048": (2048, 2048, False, "tail", (4, 8, "bhsd")),
    # whole masked 64-key tiles and 128-key blocks, which the backward pair
    # skips: a block whose first warpgroup's keys are all masked, one
    # whose second's are, and a row with a single live tile
    "skipped_tiles": (512, 512, False, "tiles", (4, 8, "heads")),
    # the long walk on a small grid (the sp_encode gradient's role)
    "b1_sk8192": (8192, 8192, False, "tail", (1, 8, "heads")),
}
# the head dims of the backward pair's Hopper instances
PAIR_HEAD_DIMS = (64, 96, 128)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _qkv_mask(device, case, d=96):
    """q, k, v (bf16, seed 0, head dim ``d``) and the key mask of a
    ``FLASH_CASES`` case."""
    sq, sk, _, kind, (b, h, layout) = FLASH_CASES[case]
    g = torch.Generator(device=device).manual_seed(0)

    def make(s):
        if layout == "heads":
            return torch.randn(b, s, h * d, generator=g, device=device,
                               dtype=torch.bfloat16).view(
                                   b, s, h, d).transpose(1, 2)
        return torch.randn(b, h, s, d, generator=g, device=device,
                           dtype=torch.bfloat16)
    q, k, v = make(sq), make(sk), make(sk)
    mask = None
    keys = torch.arange(sk, device=device)
    if kind == "tiles":
        mask = torch.stack([(keys >= 64) & (keys < 128) | (keys >= 448),
                            keys % 128 < 64,
                            (keys >= 256) & (keys < 320),
                            keys % 128 >= 64][:b])
    elif kind is not None:
        lens = torch.tensor([sk - 7, sk // 2, sk // 3, sk - 100][:b],
                            device=device)
        mask = keys[None, :] < lens[:, None]
        if kind == "one_row_empty":
            mask[1] = False
    return q, k, v, mask


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_kernel_matches_plain_on_card(cuda_device, case):
    """bf16 kernel vs the plain version on the same bf16 inputs: within
    2^-5 absolute (a few bf16 steps at |out| <= 4; P is rounded to bf16
    in both)."""
    causal = FLASH_CASES[case][2]
    q, k, v, mask = _qkv_mask(cuda_device, case)
    got = flash_attention(q, k, v, key_padding_mask=mask, causal=causal)
    want = flash_attention_reference(q, k, v, key_padding_mask=mask,
                                     causal=causal)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= 2 ** -5


def _rel_err(got, want) -> float:
    """Norm-wise relative error ||got - want|| / ||want||."""
    want = want.float()
    return ((got.float() - want).norm() / want.norm()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_dropout_and_lse_match_plain_on_card(cuda_device, case):
    """The forward kernel with attention dropout 0.3 (the same hash mask as
    the plain version) and its f32 LSE: output within 2^-4 absolute (the
    kept weights are scaled by 1/0.7) and 1e-2 norm-wise relative, LSE
    within 1e-3."""
    causal = FLASH_CASES[case][2]
    q, k, v, mask = _qkv_mask(cuda_device, case)
    args = dict(key_padding_mask=mask, causal=causal, dropout_rate=0.3,
                seed=77, return_lse=True)
    got, lse = flash_attention(q, k, v, **args)
    want, want_lse = flash_attention_reference(q, k, v, **args)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= 2 ** -4
    assert _rel_err(got, want) <= 1e-2
    assert (lse - want_lse).abs().max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("d", PAIR_HEAD_DIMS)
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_backward_matches_autograd_on_card(cuda_device, case, rate, d):
    """The backward kernel pair vs autograd through the plain version, same
    dO, at each head dim of its Hopper instances: dq, dk, dv within 2^-3
    absolute (dS is rounded to bf16 before the dK and dQ products, as in
    the TPU kernels) and within 1e-2 norm-wise relative (independent bf16
    roundings of ~2^-9 each; the absolute bound alone checks only the peak
    entries); a fully-masked row gets dq = 0."""
    causal, kind = FLASH_CASES[case][2:4]
    q, k, v, mask = _qkv_mask(cuda_device, case, d)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    dout = torch.randn_like(q)
    args = dict(key_padding_mask=mask, causal=causal, dropout_rate=rate,
                seed=5)
    got = torch.autograd.grad(flash_attention(q, k, v, **args), (q, k, v),
                              dout)
    want = torch.autograd.grad(flash_attention_reference(q, k, v, **args),
                               (q, k, v), dout)
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert (a.float() - w.float()).abs().max().item() <= 2 ** -3
        assert _rel_err(a, w) <= 1e-2
    if kind == "one_row_empty":
        assert got[0][1].abs().max().item() == 0.0


@pytest.mark.cuda
def test_flash_takes_2_32_scores_without_dropout_on_card(cuda_device):
    """B=512 at L=1024 (the analyzer's batch_size=512): B*H*Sq*Sk = 2^32,
    past the dropout hash's 32-bit index, runs forward and backward without
    dropout; the first and last batch rows match the plain version on
    those rows alone (rows are independent) within the bounds above."""
    b, h, s = 512, 8, 1024
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def heads():
        return torch.randn(b, s, h * 96, generator=g, device=cuda_device,
                           dtype=torch.bfloat16).view(b, s, h, 96).transpose(1, 2)
    q, k, v, dout = heads(), heads(), heads(), heads()
    mask = torch.arange(s, device=cuda_device)[None, :] < torch.randint(
        1, s + 1, (b, 1), generator=g, device=cuda_device)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = flash_attention(q, k, v, key_padding_mask=mask)
    grads = torch.autograd.grad(out, (q, k, v), dout)
    for i in (0, b - 1):
        rows = [t[i:i + 1].detach().requires_grad_() for t in (q, k, v)]
        want = flash_attention_reference(*rows, key_padding_mask=mask[i:i + 1])
        want_g = torch.autograd.grad(want, rows, dout[i:i + 1])
        torch.cuda.synchronize()
        assert (out[i:i + 1].float() - want.float()).abs().max().item() <= 2 ** -5
        for got, w in zip(grads, want_g):
            assert (got[i:i + 1].float() - w.float()).abs().max().item() <= 2 ** -3
            assert _rel_err(got[i:i + 1], w) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("d", PAIR_HEAD_DIMS)
@pytest.mark.parametrize("case", ["causal_1000", "b4_h8_2048",
                                  "skipped_tiles"])
def test_flash_backward_is_deterministic_on_card(cuda_device, case, d):
    """The backward pair uses no atomics: two runs on the same inputs, with
    dropout 0.3, give bit-identical dq, dk and dv."""
    causal = FLASH_CASES[case][2]
    q, k, v, mask = _qkv_mask(cuda_device, case, d)
    scale = d ** -0.5
    out, lse = flash_attention(q, k, v, key_padding_mask=mask, causal=causal,
                               sm_scale=scale, dropout_rate=0.3, seed=5,
                               return_lse=True)
    dout = torch.randn_like(q)
    runs = [flash_attention_backward(q, k, v, out, lse, dout, mask, causal,
                                     scale, 0.3, 5) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_kernel_matches_plain_on_card(cuda_device, dtype):
    """The hash dropout kernel, forward and backward, equals the plain
    version exactly on a ragged size (the tail past the last 16-byte
    chunk)."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(3, 1001, 77, generator=g, device=cuda_device).to(dtype)
    x.requires_grad_()
    y = dropout(x, 0.3, 12345)
    gy = torch.randn_like(y)
    (dx,) = torch.autograd.grad(y, x, gy)
    torch.cuda.synchronize()
    assert torch.equal(y, dropout_reference(x.detach(), 12345, 0.3))
    assert torch.equal(dx, dropout_reference(gy, 12345, 0.3))


@pytest.mark.cuda
def test_shard_origins_match_plain_on_card(cuda_device):
    """A mesh rank's kernels draw the one-card masks at its shard: K6 on
    rows [2, 4) and columns [40, 77) of a (4, 1001, 77) tensor (exact,
    forward and backward), and K1 and the pair on batch rows [2, 4) and
    heads [4, 8) of 8 with dropout 0.3, within the bounds of
    ``test_flash_dropout_and_lse_match_plain_on_card`` and
    ``test_flash_backward_matches_autograd_on_card``."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(2, 1001, 37, generator=g, device=cuda_device).to(
        torch.bfloat16).requires_grad_()
    origin = 2 * 1001 * 77 + 40
    y = dropout(x, 0.3, 12345, origin, 77)
    gy = torch.randn_like(y)
    (dx,) = torch.autograd.grad(y, x, gy)
    torch.cuda.synchronize()
    assert torch.equal(y, dropout_reference(x.detach(), 12345, 0.3, origin,
                                            77))
    assert torch.equal(dx, dropout_reference(gy, 12345, 0.3, origin, 77))
    q, k, v = (torch.randn(2, 4, 256, 96, generator=g, device=cuda_device,
                           dtype=torch.bfloat16).requires_grad_()
               for _ in range(3))
    args = dict(dropout_rate=0.3, seed=7, drop_shard=(2, 4, 8))
    got = flash_attention(q, k, v, **args)
    want = flash_attention_reference(q, k, v, **args)
    dout = torch.randn_like(got)
    gots = torch.autograd.grad(got, (q, k, v), dout)
    wants = torch.autograd.grad(want, (q, k, v), dout)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= 2 ** -4
    assert _rel_err(got, want) <= 1e-2
    for a, w in zip(gots, wants):
        assert (a.float() - w.float()).abs().max().item() <= 2 ** -3
        assert _rel_err(a, w) <= 1e-2


DECODE_CASES = {
    # name: (B, S, layout, mask kind); layout "cache" is the contiguous
    # (B, 8, S_max, 96) self cache cut to S keys (a strided view), "heads"
    # the cross K/V's (B, 8, S, 96) view of (B, S, 768). The kernel splits
    # a (b, h)'s keys over up to 8 blocks of 64-key tiles (8 at B=2,
    # S=1024; 1 at B=64)
    "self_pos0": (2, 1, "cache", None),
    "self_pos127": (2, 128, "cache", None),
    "self_pos1023": (2, 1024, "cache", None),
    # the tile edges
    "self_pos63": (2, 64, "cache", None),
    "self_pos64": (2, 65, "cache", None),
    "self_pos65": (2, 66, "cache", None),
    # lens 874 and 750: row 1's last two splits attend no key
    "cross_src_mask": (2, 1024, "heads", "src"),
    "last_key_only": (2, 1024, "heads", "last"),
    "fully_masked_row": (2, 1024, "heads", "row_empty"),
    "b1_cross": (1, 1024, "heads", "src"),
    "b64_cross": (64, 1024, "heads", "src"),
    "s16384_past_the_old_limit": (2, 16384, "cache", None),
    "two_runs_same_bits": (2, 1024, "heads", "src"),
}


def _decode_inputs(device, case):
    """q, k, v (bf16, seed 0) and the key mask of a ``DECODE_CASES`` case."""
    b, s, layout, kind = DECODE_CASES[case]
    g = torch.Generator(device=device).manual_seed(0)
    q = torch.randn(b, 8, 1, 96, generator=g, device=device,
                    dtype=torch.bfloat16)
    if layout == "cache":
        cache = torch.randn(2, b, 8, max(s, 1024), 96, generator=g,
                            device=device, dtype=torch.bfloat16)
        k, v = cache[0, :, :, :s], cache[1, :, :, :s]
    else:
        k, v = (torch.randn(b, s, 768, generator=g, device=device,
                            dtype=torch.bfloat16).view(b, s, 8, 96)
                .transpose(1, 2) for _ in range(2))
    if kind is None:
        return q, k, v, None
    lens = (torch.tensor([s - 150, s - 274][:b], device=device) if b <= 2
            else torch.randint(1, s + 1, (b,), generator=g, device=device))
    mask = torch.arange(s, device=device)[None, :] < lens[:, None]
    if kind == "last":
        mask[0] = False
        mask[0, -1] = True
    elif kind == "row_empty":
        mask[1] = False
    return q, k, v, mask


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_kernel_matches_plain_on_card(cuda_device, case):
    """The bf16 split-K kernel vs the plain version on the same inputs:
    within 2^-6 absolute (|out| < 2, bf16 steps of 2^-8; the kernel keeps
    P in f32 where the plain version rounds it to bf16) and 1e-2 norm-wise
    relative. A fully-masked row gives zeros; two runs give the same bits
    (the splits are combined in a fixed order)."""
    q, k, v, mask = _decode_inputs(cuda_device, case)
    got = decode_attention(q, k, v, mask, sm_scale=96 ** -0.5)
    want = decode_attention_reference(q, k, v, mask, sm_scale=96 ** -0.5)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= 2 ** -6
    assert _rel_err(got, want) <= 1e-2
    if DECODE_CASES[case][3] == "row_empty":
        assert got[1].abs().max().item() == 0.0
    if case == "two_runs_same_bits":
        again = decode_attention(q, k, v, mask, sm_scale=96 ** -0.5)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int16), again.view(torch.int16))


# head dims of the other kernel instances (64, 128, 192, 256), of the
# flash kernels' padded route (80 runs their 128 instances on a
# zero-padded copy, 160 their 192 and 224 their 256), and over 256 of the
# flash kernels' chunked route (320 padded to 384, 384: two chunks of the
# 192 instance), with their heads. K5 runs 80 and 160 in place on its 96
# and 192 instances, and 224 to 384 in place on its wide-head route
HEAD_DIM_CASES = [(64, 12), (80, 8), (128, 6), (160, 4), (192, 4), (224, 3),
                  (256, 3), (320, 2), (384, 2)]


def _head_view(g, device, b, s, h, d, scale=1.0):
    """The model's (B, H, S, d) view of (B, S, H*d) bf16 projections."""
    x = torch.randn(b, s, h * d, generator=g, device=device) * scale
    return x.to(torch.bfloat16).view(b, s, h, d).transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d,h", HEAD_DIM_CASES)
def test_flash_head_dims_match_plain_on_card(cuda_device, d, h, causal):
    """K1 (dropout 0.3, LSE) and the backward pair at each head-dim
    instance and on the padded route, Sq=200 against Sk=1000 keys under a
    key mask (the tiles' edges): the bounds of the head-dim-96 tests above;
    the scale is the true head dim's."""
    g = torch.Generator(device=cuda_device).manual_seed(d)
    q = _head_view(g, cuda_device, 2, 200, h, d, 2.0).requires_grad_()
    k, v = (_head_view(g, cuda_device, 2, 1000, h, d).requires_grad_()
            for _ in range(2))
    mask = (torch.arange(1000, device=cuda_device)[None, :]
            < torch.tensor([[993], [500]], device=cuda_device))
    args = dict(key_padding_mask=mask, causal=causal, dropout_rate=0.3,
                seed=7, return_lse=True)
    got, lse = flash_attention(q, k, v, **args)
    want, want_lse = flash_attention_reference(q, k, v, **args)
    dout = torch.randn_like(got)
    grads = torch.autograd.grad(got, (q, k, v), dout)
    want_g = torch.autograd.grad(want, (q, k, v), dout)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (2, h, 200, d)
    assert (got.float() - want.float()).abs().max().item() <= 2 ** -4
    assert _rel_err(got, want) <= 1e-2
    assert (lse - want_lse).abs().max().item() <= 1e-3
    for a, w in zip(grads, want_g):
        assert a.shape == w.shape
        assert (a.float() - w.float()).abs().max().item() <= 2 ** -3
        assert _rel_err(a, w) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["self_pos64", "cross_src_mask",
                                  "b64_cross"])
@pytest.mark.parametrize("d,h", HEAD_DIM_CASES)
def test_decode_head_dims_match_plain_on_card(cuda_device, d, h, case):
    """K5 at each head-dim instance (64, 128 and 192 store their tiles
    swizzled), at head dims it runs in place on a wider instance (80, 160)
    and on its wide-head route (224 and 320 with a part chunk, 256, 384): the
    bounds of the head-dim-96 test."""
    b, s, layout, kind = DECODE_CASES[case]
    g = torch.Generator(device=cuda_device).manual_seed(d)
    q = torch.randn(b, h, 1, d, generator=g, device=cuda_device,
                    dtype=torch.bfloat16)
    if layout == "cache":
        cache = torch.randn(2, b, h, 1024, d, generator=g, device=cuda_device,
                            dtype=torch.bfloat16)
        k, v = cache[0, :, :, :s], cache[1, :, :, :s]
    else:
        k, v = (_head_view(g, cuda_device, b, s, h, d) for _ in range(2))
    mask = None
    if kind is not None:
        lens = (torch.tensor([s - 150, s - 274], device=cuda_device)
                if b <= 2 else torch.randint(1, s + 1, (b,), generator=g,
                                             device=cuda_device))
        mask = torch.arange(s, device=cuda_device)[None, :] < lens[:, None]
    got = decode_attention(q, k, v, mask, sm_scale=d ** -0.5)
    want = decode_attention_reference(q, k, v, mask, sm_scale=d ** -0.5)
    torch.cuda.synchronize()
    assert got.shape == (b, h, 1, d)
    assert (got.float() - want.float()).abs().max().item() <= 2 ** -6
    assert _rel_err(got, want) <= 1e-2


@pytest.mark.cuda
def test_head_dim_over_128_raises_on_card(cuda_device):
    """A head dim over 128 once raised on the card; 160 now runs K1's 192
    instance on a copy padded to 192 and K5's 192 instance in place, and
    counts their launches."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    q = torch.randn(1, 2, 8, 160, generator=g, device=cuda_device,
                    dtype=torch.bfloat16)
    before = (flash_attention.launches, decode_attention.launches)
    got = flash_attention(q, q, q)
    dec = decode_attention(q[:, :, :1], q, q, sm_scale=0.1)
    torch.cuda.synchronize()
    assert (flash_attention.launches, decode_attention.launches) == (
        before[0] + 1, before[1] + 1)
    want = flash_attention_reference(q, q, q)
    assert (got.float() - want.float()).abs().max().item() <= 2 ** -5
    want = decode_attention_reference(q[:, :, :1], q, q, sm_scale=0.1)
    assert (dec.float() - want.float()).abs().max().item() <= 2 ** -6


# K5's shapes with no padded copy: (B, H, S, d) at B=64, every key
# attended; 192 is ModelConfig(nhead=4)'s decode batch
IN_PLACE_CASES = [(64, 4, 1024, 192), (64, 8, 1024, 80), (64, 4, 1024, 160),
                  (64, 3, 1024, 224), (64, 3, 1024, 256), (64, 2, 1024, 320)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,s,d", IN_PLACE_CASES)
def test_decode_makes_no_padded_copy_on_card(cuda_device, b, h, s, d):
    """K5 on its 192 instance, in place on a wider instance at 80 and 160,
    and on its wide-head route at 224, 256 and 320, allocates nothing on
    the card but its output (the key mask is
    read in place): no padded copy of q, K or V. It still matches the plain
    version within the head-dim tests' bounds."""
    g = torch.Generator(device=cuda_device).manual_seed(d)
    q = _head_view(g, cuda_device, b, 1, h, d, 2.0)
    k, v = (_head_view(g, cuda_device, b, s, h, d) for _ in range(2))
    mask = torch.ones(b, s, dtype=torch.bool, device=cuda_device)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = decode_attention(q, k, v, mask, sm_scale=d ** -0.5)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - before
    out_bytes = -(-got.numel() * got.element_size() // 512) * 512
    assert grown <= out_bytes, (grown, out_bytes)
    want = decode_attention_reference(q, k, v, mask, sm_scale=d ** -0.5)
    assert (got.float() - want.float()).abs().max().item() <= 2 ** -6
    assert _rel_err(got, want) <= 1e-2


@pytest.mark.cuda
def test_decode_192_gives_the_same_bits_twice_on_card(cuda_device):
    """K5's 192 instance at B=2 (8 splits, combined in split order in one
    cluster) gives the same bits on two runs."""
    g = torch.Generator(device=cuda_device).manual_seed(192)
    mask = (torch.arange(1024, device=cuda_device)[None, :]
            < torch.tensor([[874], [750]], device=cuda_device))
    q = _head_view(g, cuda_device, 2, 1, 4, 192, 2.0)
    k, v = (_head_view(g, cuda_device, 2, 1024, 4, 192) for _ in range(2))
    runs = [decode_attention(q, k, v, mask, sm_scale=192 ** -0.5)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0].view(torch.int16), runs[1].view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("d,h", [(192, 4), (256, 3), (320, 2), (384, 2)])
def test_wide_routes_take_the_concat_mask_on_card(cuda_device, d, h):
    """K1 (dropout 0.3, LSE) and the backward pair at their 192 and 256
    instances and chunked over 256, and K5 at its 192 instance and on its
    wide-head route, under
    ``encode_concat``'s key mask, whose rows have a hole in the middle (the
    contract's padding, then the AST's tokens): the bounds of the head-dim
    tests above."""
    g = torch.Generator(device=cuda_device).manual_seed(d)
    s, half = 256, 128
    pos = torch.arange(half, device=cuda_device)[None, :]
    mask = torch.cat([pos < torch.tensor([[40], [128]], device=cuda_device),
                      pos < torch.tensor([[100], [7]], device=cuda_device)],
                     dim=1)
    q = _head_view(g, cuda_device, 2, s, h, d, 2.0).requires_grad_()
    k, v = (_head_view(g, cuda_device, 2, s, h, d).requires_grad_()
            for _ in range(2))
    args = dict(key_padding_mask=mask, dropout_rate=0.3, seed=3,
                return_lse=True)
    got, lse = flash_attention(q, k, v, **args)
    want, want_lse = flash_attention_reference(q, k, v, **args)
    dout = torch.randn_like(got)
    grads = torch.autograd.grad(got, (q, k, v), dout)
    want_g = torch.autograd.grad(want, (q, k, v), dout)
    with torch.no_grad():
        dec = decode_attention(q[:, :, :1], k, v, mask, sm_scale=d ** -0.5)
        dec_want = decode_attention_reference(q[:, :, :1], k, v, mask,
                                              sm_scale=d ** -0.5)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= 2 ** -4
    assert _rel_err(got, want) <= 1e-2
    assert (lse - want_lse).abs().max().item() <= 1e-3
    for a, w in zip(grads, want_g):
        assert (a.float() - w.float()).abs().max().item() <= 2 ** -3
        assert _rel_err(a, w) <= 1e-2
    assert (dec.float() - dec_want.float()).abs().max().item() <= 2 ** -5
    assert _rel_err(dec, dec_want) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("d,h", [(192, 4), (256, 3), (320, 2), (384, 2)])
def test_wide_instances_take_shard_origins_and_long_keys_on_card(
        cuda_device, d, h):
    """K1 (dropout 0.3, LSE) and the backward pair at 192, 256 and chunked
    over 256: at a shard origin (b0, h0, hg) = (1, 2, h + 3) of the
    dropout grid, and at Sk = 2048 (the pair's K3/K4 role: several key
    tiles a query row) under a key mask with an empty row; the bounds of
    the head-dim tests above."""
    g = torch.Generator(device=cuda_device).manual_seed(d + 1)
    cases = [(dict(drop_shard=(1, 2, h + 3), dropout_rate=0.3), 256, 384,
              [[384], [200]]),
             (dict(dropout_rate=0.0), 300, 2048, [[2041], [0]])]
    for extra, sq, sk, lens in cases:
        q = _head_view(g, cuda_device, 2, sq, h, d, 2.0).requires_grad_()
        k, v = (_head_view(g, cuda_device, 2, sk, h, d).requires_grad_()
                for _ in range(2))
        mask = (torch.arange(sk, device=cuda_device)[None, :]
                < torch.tensor(lens, device=cuda_device))
        args = dict(key_padding_mask=mask, seed=5, return_lse=True, **extra)
        got, lse = flash_attention(q, k, v, **args)
        want, want_lse = flash_attention_reference(q, k, v, **args)
        dout = torch.randn_like(got)
        grads = torch.autograd.grad(got, (q, k, v), dout)
        want_g = torch.autograd.grad(want, (q, k, v), dout)
        torch.cuda.synchronize()
        assert (got.float() - want.float()).abs().max().item() <= 2 ** -4
        assert _rel_err(got, want) <= 1e-2
        assert (lse - want_lse).abs().max().item() <= 1e-3
        for a, w in zip(grads, want_g):
            assert (a.float() - w.float()).abs().max().item() <= 2 ** -3
            assert _rel_err(a, w) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("d", [200, 320])
def test_flash_refuses_a_head_dim_no_route_takes_on_card(cuda_device, d):
    """Called directly, the kernels' wrappers raise on a head dim that is
    neither an instance nor a multiple of 256 or 192 over 256 (the public
    function pads it first), and nothing is launched."""
    q = torch.zeros(1, 2, 64, d, device=cuda_device, dtype=torch.bfloat16)
    lse = torch.zeros(1, 2, 64, device=cuda_device)
    before = (flash_attention.launches, flash_attention_backward.launches)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_backward(q, q, q, q, lse, q, None, False, 0.1, 0.0, 0)
    with pytest.raises(ValueError, match="head dim"):
        _forward(q, q, q, None, False, 0.1, 0.0, 0, True, (0, 0, 2))
    assert (flash_attention.launches,
            flash_attention_backward.launches) == before


def _bf16_steps(want, steps=2) -> float:
    """``steps`` bf16 steps at the largest |value| of ``want``."""
    top = max(want.float().abs().max().item(), 2.0 ** -8)
    return steps * 2.0 ** (math.floor(math.log2(top)) - 7)


def _tool_input(device, dh, seq=256):
    g = torch.Generator(device=device).manual_seed(0)
    return (torch.randn(2, 8, seq, dh, generator=g, device=device)
            * 0.5).to(torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [96, 128])
@pytest.mark.parametrize("mode", k7.MODES)
def test_flash_parts_kernel_matches_plain_on_card(cuda_device, mode, dh):
    """K7, each mode: within two bf16 steps at the largest |output| (both
    round P and the output to bf16, at different places) and 1e-2
    norm-wise relative."""
    x = _tool_input(cuda_device, dh)
    got, want = k7.flash_parts(x, mode), k7.flash_parts_reference(x, mode)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= _bf16_steps(want)
    assert _rel_err(got, want) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [96, 128])
@pytest.mark.parametrize("mode", k8.MODES)
def test_flash_variants_kernel_matches_plain_on_card(cuda_device, mode, dh):
    """K8, each mode: the bound of the K7 test."""
    x = _tool_input(cuda_device, dh)
    got = k8.flash_variants(x, mode)
    want = k8.flash_variants_reference(x, mode)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= _bf16_steps(want)
    assert _rel_err(got, want) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["v2", "v3"])
def test_decode_variants_kernel_matches_plain_on_card(cuda_device, mode):
    """K9 v2 and v3 on a key mask with a fully-masked row: within two bf16
    steps at the largest |output|, that row zeros."""
    q, k, v, mask = k9.make_inputs(4, 8, 300, 96, 0, cuda_device)
    mask[2] = False
    got = k9.decode_variants(q, k, v, mask, mode, sm_scale=96 ** -0.5)
    want = k9.decode_variants_reference(q, k, v, mask, sm_scale=96 ** -0.5)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= _bf16_steps(want)
    assert _rel_err(got, want) <= 1e-2
    assert got[2].abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", k10.MODES)
def test_dropout_variants_kernel_matches_plain_on_card(cuda_device, mode):
    """K10, each mode: bit for bit (bf16 bit patterns)."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(100, 96, generator=g, device=cuda_device).to(
        torch.bfloat16)
    got = k10.dropout_variants(x, mode, 0.1, 99)
    want = k10.dropout_variants_reference(x, mode, 0.1, 99)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("timer", ["chain", "ring"])
def test_graph_timers_call_once_eagerly_and_n_times_captured(cuda_device,
                                                             timer):
    """``chain_ms`` and ``ring_ms``: one eager call, ``n`` captured; the
    replays call nothing and the graph's results are the eager ones."""
    x0 = torch.ones(64, 64, device=cuda_device)
    calls, outs = [], []

    def step(x):
        calls.append(1)
        outs.append(x * 2)
        return outs[-1]
    if timer == "chain":
        ms = profiling.chain_ms(step, x0, 5)
    else:
        ms = profiling.ring_ms(step, [x0.clone() for _ in range(3)], 5)
    torch.cuda.synchronize()
    assert len(calls) == 1 + 5 and ms > 0.0
    assert outs[-1].max().item() == (2.0 ** 5 if timer == "chain" else 2.0)
