"""The port's CUDA kernels against their plain versions, on a CUDA card.

Marked ``cuda``; without a card each test skips. This file imports no JAX,
so it runs on a machine that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(``chip_smoke.py`` checks the same kernels at the main path's full shapes.)
"""
import pytest
import torch

from sct_gan_tpu_torch.ops.decode_attention import (
    decode_attention, decode_attention_reference)
from sct_gan_tpu_torch.ops.dropout import dropout, dropout_reference
from sct_gan_tpu_torch.ops.flash_attention import (flash_attention,
                                                   flash_attention_reference)

FLASH_CASES = {
    # name: (sq, sk, causal, mask kind)
    "key_mask": (128, 128, False, "tail"),
    "causal": (128, 128, True, None),
    "sq_ne_sk": (64, 160, False, "tail"),
    "ragged": (100, 100, True, "tail"),
    "fully_masked_row": (64, 96, False, "one_row_empty"),
}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_kernel_matches_plain_on_card(cuda_device, case):
    """bf16 kernel vs the plain version on the same bf16 inputs: within
    2^-5 absolute (a few bf16 steps at |out| <= 4; P is rounded to bf16
    in both)."""
    sq, sk, causal, kind = FLASH_CASES[case]
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(2, 8, s, 96, generator=g, device=cuda_device,
                           dtype=torch.bfloat16) for s in (sq, sk, sk))
    mask = None
    if kind is not None:
        mask = (torch.arange(sk, device=cuda_device)[None, :]
                < torch.tensor([[sk - 7], [sk // 2]], device=cuda_device))
        if kind == "one_row_empty":
            mask[1] = False
    got = flash_attention(q, k, v, key_padding_mask=mask, causal=causal)
    want = flash_attention_reference(q, k, v, key_padding_mask=mask,
                                     causal=causal)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= 2 ** -5


def _rel_err(got, want) -> float:
    """Norm-wise relative error ||got - want|| / ||want||."""
    want = want.float()
    return ((got.float() - want).norm() / want.norm()).item()


def _qkv_mask(device, sq, sk, kind, b=2):
    g = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn(b, 8, s, 96, generator=g, device=device,
                           dtype=torch.bfloat16) for s in (sq, sk, sk))
    mask = None
    if kind is not None:
        mask = (torch.arange(sk, device=device)[None, :]
                < torch.tensor([[sk - 7], [sk // 2]], device=device))
        if kind == "one_row_empty":
            mask[1] = False
    return q, k, v, mask


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_dropout_and_lse_match_plain_on_card(cuda_device, case):
    """The forward kernel with attention dropout 0.3 (the same hash mask as
    the plain version) and its f32 LSE: output within 2^-4 absolute (the
    kept weights are scaled by 1/0.7) and 1e-2 norm-wise relative, LSE
    within 1e-3."""
    sq, sk, causal, kind = FLASH_CASES[case]
    q, k, v, mask = _qkv_mask(cuda_device, sq, sk, kind)
    args = dict(key_padding_mask=mask, causal=causal, dropout_rate=0.3,
                seed=77, return_lse=True)
    got, lse = flash_attention(q, k, v, **args)
    want, want_lse = flash_attention_reference(q, k, v, **args)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max().item() <= 2 ** -4
    assert _rel_err(got, want) <= 1e-2
    assert (lse - want_lse).abs().max().item() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_backward_matches_autograd_on_card(cuda_device, case, rate):
    """The backward kernel pair vs autograd through the plain version, same
    dO: dq, dk, dv within 2^-3 absolute (dS is rounded to bf16 before the
    dK and dQ products, as in the TPU kernels) and within 1e-2 norm-wise
    relative (independent bf16 roundings of ~2^-9 each; the absolute bound
    alone checks only the peak entries); a fully-masked row gets dq = 0."""
    sq, sk, causal, kind = FLASH_CASES[case]
    q, k, v, mask = _qkv_mask(cuda_device, sq, sk, kind)
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
def test_decode_kernel_matches_plain_on_card(cuda_device):
    """bf16 kernel on a strided cache view vs the plain version: within
    2^-6 absolute."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    cache = torch.randn(2, 2, 8, 1024, 96, generator=g, device=cuda_device,
                        dtype=torch.bfloat16)
    q = torch.randn(2, 8, 1, 96, generator=g, device=cuda_device,
                    dtype=torch.bfloat16)
    for pos in (0, 127, 1023):
        k, v = cache[0, :, :, :pos + 1], cache[1, :, :, :pos + 1]
        got = decode_attention(q, k, v, None, sm_scale=96 ** -0.5)
        want = decode_attention_reference(q, k, v, None, sm_scale=96 ** -0.5)
        torch.cuda.synchronize()
        assert (got.float() - want.float()).abs().max().item() <= 2 ** -6
