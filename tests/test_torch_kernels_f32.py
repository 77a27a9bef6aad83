"""The port's f32 CUDA kernels against their plain f32 versions, on a card.

The f32 instances of K1, the backward pair and K5
(``csrc/flash_attention_fwd_f32.cu``, ``flash_attention_bwd_f32.cu``,
``decode_attention_f32.cu``) at ``test_torch_kernels.py``'s cases, on
the same inputs in f32. Marked ``cuda``; without a card each test skips.
This file imports no JAX:

    python -m pytest --noconftest -m cuda -p no:cacheprovider tests/test_torch_kernels_f32.py

Tolerances: the kernels run every product in 3xTF32 (~2^-22 relative
each) and sum in another order than the plain version's full-f32
products, so the forward and K5 are held to 1e-5 and the gradients (one
more softmax, dS, and dK and dV summed over the queries) to 1e-4,
norm-wise; a bf16 query's output is rounded to bf16 on both sides once.
"""
import pytest
import torch

from sct_gan_tpu_torch.ops.attention import attention_keep
from sct_gan_tpu_torch.ops.decode_attention import (
    decode_attention, decode_attention_reference)
from sct_gan_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_reference)
from test_torch_kernels import (DECODE_CASES, FLASH_CASES, PAIR_HEAD_DIMS,
                                _decode_inputs, _qkv_mask, _rel_err,
                                cuda_device)

FWD_TOL = 1e-5
BWD_TOL = 1e-4
# the long walk's plain f32 backward holds (8, 8192, 8192) f32 scores
# several times over: it stays with the bf16 tests
F32_FLASH_CASES = sorted(c for c in FLASH_CASES if c != "b1_sk8192")


def _f32(device, case, d):
    """A case's inputs (``_qkv_mask``) in f32, the same layout."""
    q, k, v, mask = _qkv_mask(device, case, d)
    return q.float(), k.float(), v.float(), mask


@pytest.mark.cuda
@pytest.mark.parametrize("d", PAIR_HEAD_DIMS)
@pytest.mark.parametrize("case", F32_FLASH_CASES)
def test_f32_flash_forward_matches_plain_on_card(cuda_device, case, d):
    """The f32 K1 with dropout 0.3 and its LSE, at each f32 instance:
    output in f32 within 1e-5 and the LSE of the rows that attend a key
    within 1e-5 norm-wise; a fully-masked row gives zeros and lse =
    -1e30."""
    causal, kind = FLASH_CASES[case][2:4]
    q, k, v, mask = _f32(cuda_device, case, d)
    args = dict(key_padding_mask=mask, causal=causal, dropout_rate=0.3,
                seed=77, return_lse=True)
    got, lse = flash_attention(q, k, v, **args)
    want, want_lse = flash_attention_reference(q, k, v, **args)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert _rel_err(got, want) <= FWD_TOL
    live = want_lse > -1e29          # a fully-masked row's is -1e30
    assert _rel_err(lse[live], want_lse[live]) <= FWD_TOL
    if kind == "one_row_empty":
        assert got[1].abs().max().item() == 0.0
        assert bool((lse[1] == -1e30).all())


@pytest.mark.cuda
@pytest.mark.parametrize("d", PAIR_HEAD_DIMS)
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("case", F32_FLASH_CASES)
def test_f32_flash_backward_matches_autograd_on_card(cuda_device, case,
                                                     rate, d):
    """The f32 pair (D, dKV, dQ) vs autograd through the plain version,
    same dO: dq, dk, dv within 1e-4 norm-wise; a fully-masked row gets
    dq = 0; two runs give the same bits (no atomics)."""
    causal, kind = FLASH_CASES[case][2:4]
    q, k, v, mask = _f32(cuda_device, case, d)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    dout = torch.randn_like(q)
    args = dict(key_padding_mask=mask, causal=causal, dropout_rate=rate,
                seed=5)
    got = torch.autograd.grad(flash_attention(q, k, v, **args), (q, k, v),
                              dout)
    again = torch.autograd.grad(flash_attention(q, k, v, **args), (q, k, v),
                                dout)
    want = torch.autograd.grad(flash_attention_reference(q, k, v, **args),
                               (q, k, v), dout)
    torch.cuda.synchronize()
    for a, b, w in zip(got, again, want):
        assert a.dtype == torch.float32 and _rel_err(a, w) <= BWD_TOL
        assert torch.equal(a, b)
    if kind == "one_row_empty":
        assert got[0][1].abs().max().item() == 0.0


@pytest.mark.cuda
def test_f32_dropout_keep_bits_equal_the_plain_mask_on_card(cuda_device):
    """q = 0 makes P uniform over the attended keys, so with V the 64 x 64
    identity on one 64-key window (a key mask) the f32 K1's output is the
    keep bit over 64 / (1 - rate), or 0: every bit at (2, 8, 256, 256)
    equals the plain version's hash mask."""
    dev, b, h, s, rate = cuda_device, 2, 8, 256, 0.3
    q = torch.zeros(b, h, s, 64, device=dev)
    k = torch.randn(b, h, s, 64, device=dev)
    v = torch.eye(64, device=dev).repeat(s // 64, 1).expand(
        b, h, s, 64).contiguous()
    want = attention_keep((b, h, s, s), 11, rate, None, dev)
    got = torch.empty_like(want)
    for w in range(s // 64):
        mask = torch.zeros(b, s, dtype=torch.bool, device=dev)
        mask[:, 64 * w:64 * (w + 1)] = True
        out = flash_attention(q, k, v, key_padding_mask=mask,
                              dropout_rate=rate, seed=11)
        got[..., 64 * w:64 * (w + 1)] = out > 0
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16],
                         ids=["f32_query", "bf16_query"])
@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_f32_decode_matches_plain_on_card(cuda_device, case, qdtype):
    """K5 over f32 caches (a bf16 query upcast exactly, the output in the
    query's dtype): within 1e-5 norm-wise for an f32 query, 1e-2 for a
    bf16 one (both sides round the same f32 value to bf16 once). A
    fully-masked row gives zeros; two runs give the same bits."""
    q, k, v, mask = _decode_inputs(cuda_device, case)
    q, k, v = q.to(qdtype), k.float(), v.float()
    got = decode_attention(q, k, v, mask, sm_scale=96 ** -0.5)
    again = decode_attention(q, k, v, mask, sm_scale=96 ** -0.5)
    want = decode_attention_reference(q, k, v, mask, sm_scale=96 ** -0.5)
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == qdtype
    assert _rel_err(got, want) <= (FWD_TOL if qdtype == torch.float32
                                   else 1e-2)
    assert torch.equal(got, again)
    if DECODE_CASES[case][3] == "row_empty":
        assert got[1].abs().max().item() == 0.0


@pytest.mark.cuda
def test_f32_routes_raise_on_card(cuda_device):
    """An f32 head dim over 128, mixed q/k/v dtypes in the flash wrapper,
    and a bf16 cache under an f32 query raise; nothing is cast."""
    dev = cuda_device
    x = torch.randn(1, 2, 64, 192, device=dev)
    with pytest.raises(ValueError, match="head dim 192 in float32"):
        flash_attention(x, x, x)
    y = torch.randn(1, 2, 64, 64, device=dev)
    with pytest.raises(ValueError, match="dtypes"):
        flash_attention(y, y.to(torch.bfloat16), y)
    with pytest.raises(ValueError, match="head dim 192 in float32"):
        decode_attention(x[:, :, :1], x, x, None, sm_scale=0.1)
    with pytest.raises(ValueError, match="dtypes"):
        decode_attention(y[:, :, :1], y.to(torch.bfloat16),
                         y.to(torch.bfloat16), None, sm_scale=0.1)
